"""`correct` at sizes a CPU holds: a sound run passes, the control (the plain
reference in the system's place, in bfloat16) reads over the limits, and a run
with the timed path broken underneath comes out not correct, once for each
fault a cell can have. The exchange between cards is not one: every cell
runs on one card and its path has no collective."""

import pytest
import torch

from conftest import TINY, tiny_cell
from portbench import readings
from portbench.run import run_cell

CPU = torch.device("cpu")


def run(tmp_path, name):
    result, loaded = run_cell(tiny_cell(tmp_path, name), 2**31 + 7, 0.0, False, CPU)
    assert not loaded
    return result


def _unchanged_csp(monkeypatch):
    from pyp_tpu_torch.ops import csp

    def unchanged(params, xv, *a, **k):
        S, P = xv.shape[0], xv.shape[2]
        return params, torch.zeros(S, 4), torch.zeros(S, P)
    monkeypatch.setattr(csp, "csp_refine_batch", unchanged)


def _half_batch_csp(monkeypatch):
    from pyp_tpu_torch.ops import reconstruct

    inner = reconstruct.accumulate_matrices

    def half(w, R, s, df, sub, wt, *a, **k):
        return inner(w[::2], R[::2], s[::2], df[::2], sub[::2], wt[::2] * 2, *a, **k)
    monkeypatch.setattr(reconstruct, "accumulate_matrices", half)


def _altered_csp(monkeypatch):
    from pyp_tpu_torch.ops import reconstruct

    inner = reconstruct.accumulate_matrices

    def altered(*a, **k):
        acc = inner(*a, **k)
        return acc._replace(num1=acc.num1 * 1.001)
    monkeypatch.setattr(reconstruct, "accumulate_matrices", altered)


@pytest.mark.parametrize("name", sorted(TINY))
def test_a_sound_run_is_correct(tmp_path, name):
    result = run(tmp_path, name)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("name, fault", [
    ("csp_modes", _unchanged_csp),
    ("csp_modes", _half_batch_csp), ("csp_modes", _altered_csp)],
    ids=lambda x: getattr(x, "__name__", x))
def test_a_broken_path_is_not_correct(tmp_path, monkeypatch, name, fault):
    fault(monkeypatch)
    result = run(tmp_path, name)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", sorted(TINY))
def test_the_control_reads_over_the_limits(tmp_path, name):
    cell = tiny_cell(tmp_path, name)
    unit = cell.unit_module().Unit(cell.config, cell.traffic, 11, CPU)
    unit.run()
    unit.release()
    sound, control, unchanged = readings.readings(unit)
    limits = cell.limits
    assert all(sound[k] <= limits[k] for k in sound), sound
    # the control computes no refinement: its parameter number is the system's
    over = {k for k in control if control[k] > limits[k]}
    assert over == set(limits) - set(unchanged), control
    assert all(unchanged[k] > limits[k] for k in unchanged), unchanged


def test_a_loaded_jax_module_is_reported(tmp_path, monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "jaxlib.fake", types.ModuleType("jaxlib.fake"))
    _, loaded = run_cell(tiny_cell(tmp_path, "csp_modes"), 3, 0.0, False, CPU)
    assert loaded == ["jaxlib"]


def test_without_a_card_the_run_exits_nonzero_and_prints_no_result(tmp_path):
    import subprocess
    import sys

    from conftest import ROOT

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         "csp_modes", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert out.returncode == 2 and out.stdout == ""


def test_a_traced_run_profiles_both_stretches_and_stays_correct(
        tmp_path, capsys, monkeypatch):
    import json

    from portbench.lib import trace

    # a CPU has no CUDA activity to profile alone: profile its host too
    real = trace.profiled
    monkeypatch.setattr(trace, "profiled", lambda host: real(True))
    result, loaded = run_cell(tiny_cell(tmp_path, "csp_modes"), 5, 0.0, True, CPU)
    assert not loaded and result["correct"], result["checks"]
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [x["stretch"] for x in lines if "stretch" in x] == ["busy", "attribution"]
    assert set(result["device"]) >= {"busy_s", "window_s"}
    assert "breakdown" in result and list(result)[-1] == "checks"
