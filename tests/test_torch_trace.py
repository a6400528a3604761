"""The port's profiler spans (`pyp_tpu_torch.utils.timer.span`) on the CPU:
nothing is recorded without a profiler; under one, the CSP refinement and
the insertion record their spans nested as the work runs (a mode holds its
start, its steps and its keep; a step holds exactly its forward, backward
and update); `Timer` is a span and waits for the card only where CUDA is
initialised. The spans' device times are read on a card
(`portbench/span_readings.py`)."""

import logging

import numpy as np
import pytest
import torch

from pyp_tpu_torch.ops import csp, fourier_slice, refine3d
from pyp_tpu_torch.ops import reconstruct as rec
from pyp_tpu_torch.utils import Timer, span
from pyp_tpu_torch.utils import timer as timer_mod

S, T, P, BOX, PIXEL = 2, 5, 4, 16, 4.0
MODES = (3, 0, 2, 1)
ITERS = 2


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU], record_shapes=True)


def _spans(prof):
    """The `pyp::` ranges of a finished profile as (name, start, end,
    keyword args), in the order they opened (an enclosing range first)."""
    out = [(ev.name(), ev.start_ns(), ev.end_ns(), dict(ev.kwinputs()))
           for ev in prof.profiler.kineto_results.events()
           if ev.name().startswith(timer_mod.PREFIX)]
    return sorted(out, key=lambda r: (r[1], -r[2]))


def _tree(spans):
    """(name, args, children) of each outermost range, children likewise."""
    root = ("", {}, [])
    stack = [(root, float("inf"))]
    for name, s, e, args in spans:
        while stack[-1][1] < e:
            stack.pop()
        node = (name[len(timer_mod.PREFIX):], args, [])
        stack[-1][0][2].append(node)
        stack.append((node, e))
    return root[2]


def _names(nodes):
    return [n[0] for n in nodes]


def _csp_inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    mask = torch.as_tensor(refine3d.make_mask_points(BOX, PIXEL, 40.0,
                                                     2.5 * PIXEL))
    G = mask.shape[0]
    vol = torch.randn((BOX,) * 3, generator=g)
    xv = torch.complex(torch.randn(S, T, P, G, generator=g),
                       torch.randn(S, T, P, G, generator=g))
    params = csp.CspParams(
        torch.linspace(-40, 40, T).repeat(S, 1),
        torch.full((S, T), 85.0),
        torch.randn(S, T, 2, generator=g),
        torch.rand(S, P, 3, generator=g) * 90,
        torch.randn(S, P, 3, generator=g) * 20,
        torch.zeros(S, T))
    centres = torch.randn(S, T, P, 2, generator=g) * 20
    df = torch.full((S, T, 2), 15000.0)
    offsets, spin = csp.build_mode_offsets(MODES, None)
    return (params, xv, centres, df, mask, fourier_slice.volume_to_fourier(vol),
            torch.ones(S, T), torch.ones(S, T, P), offsets, spin, MODES, BOX,
            PIXEL)


def _refine(series_vmap):
    return csp.csp_refine_batch(*_csp_inputs(), iters_per_mode=ITERS,
                                series_vmap=series_vmap)


def _insert(B=6):
    g = torch.Generator().manual_seed(1)
    R = csp.effective_rotations(csp.CspParams(
        torch.zeros(1, 1), torch.zeros(1, 1), torch.zeros(1, 2),
        torch.rand(B, 3, generator=g) * 90, torch.zeros(B, 3),
        torch.zeros(1))).reshape(-1, 3, 3)
    return rec.accumulate_matrices(
        torch.randn(B, BOX, BOX, generator=g), R, torch.zeros(B, 2),
        torch.full((B,), 15000.0), torch.arange(B) % 2, torch.ones(B), BOX,
        PIXEL)


@span("test.decorated")
def _decorated(x):
    return x + 1


def _raise(*args, **kwargs):
    raise AssertionError("a range was opened with no profiler running")


@pytest.mark.parametrize("what", ["context", "decorator", "timer", "refine",
                                  "insert"])
def test_no_profiler_no_range(monkeypatch, what):
    """With no profiler on, a span opens no range: both of the profiler's
    range entries raise here."""
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    assert not torch.autograd._profiler_enabled()
    if what == "context":
        with span("test.context", {"k": 1}):
            torch.ones(3).sum()
    elif what == "decorator":
        assert _decorated(torch.ones(2)).tolist() == [2.0, 2.0]
    elif what == "timer":
        with Timer("stage"):
            torch.ones(3).sum()
    elif what == "refine":
        _refine(True)
    else:
        _insert()


def test_span_records_a_named_range_with_its_args():
    with _profile() as prof:
        with span("test.context", {"mode": 3}):
            torch.ones(3).sum()
        _decorated(torch.ones(2))
        _decorated(torch.ones(2))
        with pytest.raises(ValueError):
            with span("test.raised"):
                raise ValueError
    got = [(n, a) for n, _, _, a in _spans(prof)]
    assert got == [("pyp::test.context", {"mode": 3}),
                   ("pyp::test.decorated", {}), ("pyp::test.decorated", {}),
                   ("pyp::test.raised", {})]
    with pytest.raises(TypeError):
        span("test.bad", [3])


def _check_schedule(batch):
    """One series schedule's spans: its modes in order, each holding its
    start, its steps and its keep, then the final scores."""
    names = _names(batch)
    assert names == ["csp.mode"] * len(MODES) + ["csp.scores"], names
    for mode, node in zip(MODES, batch):
        assert node[1] == {"mode": mode}
        kids = node[2]
        assert _names(kids) == (["csp.mode.start"] + ["csp.step"] * ITERS
                                + ["csp.mode.keep"])
        # shift modes gather once at the start, angle modes in every forward
        gathers_at_start = _names(kids[0][2]) == ["csp.gather"]
        assert gathers_at_start == (mode in csp.SHIFT_MODES)
        for step in kids[1:-1]:
            assert _names(step[2]) == ["csp.step.forward", "csp.step.backward",
                                       "csp.step.update"]
            fwd = _names(step[2][0][2])
            assert fwd == ([] if mode in csp.SHIFT_MODES else ["csp.gather"])
            assert step[2][1][2] == [] and step[2][2][2] == []
    assert _names(batch[-1][2]) == ["csp.gather"]


@pytest.mark.parametrize("series_vmap", [True, False])
def test_csp_refine_batch_spans_nest_as_the_work_runs(series_vmap):
    with _profile() as prof:
        _refine(series_vmap)
    top = _tree(_spans(prof))
    assert _names(top) == ["csp.refine_batch"]
    inner = top[0][2]
    if series_vmap:
        _check_schedule(inner)
    else:                       # one schedule after another, series by series
        per = len(MODES) + 1
        assert len(inner) == S * per
        for s in range(S):
            _check_schedule(inner[s * per:(s + 1) * per])
    steps = [n for n, _, _, _ in _spans(prof) if n == "pyp::csp.step"]
    assert len(steps) == len(MODES) * ITERS * (1 if series_vmap else S)


def test_insertion_spans():
    with _profile() as prof:
        _insert()
    assert _tree(_spans(prof)) == [("reconstruct.accumulate_matrices", {},
                                    [("insert.scatter", {}, [])])]


def test_spans_change_no_result():
    """The same refinement with and without a profiler recording its spans."""
    plain = _refine(True)
    with _profile():
        traced = _refine(True)
    for a, b in zip(plain[0] + plain[1:], traced[0] + traced[1:]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_timer_is_a_span_and_logs(caplog):
    with caplog.at_level(logging.INFO, logger=timer_mod.logger.name):
        with _profile() as prof:
            with Timer("csp refinement s1") as t:
                torch.ones(3).sum()
    assert [n for n, _, _, _ in _spans(prof)] == ["pyp::csp refinement s1"]
    assert t.elapsed > 0
    assert "csp refinement s1 took" in caplog.text


@pytest.mark.parametrize("initialised", [False, True])
def test_timer_synchronises_only_where_cuda_is_initialised(monkeypatch,
                                                           initialised):
    calls = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: initialised)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append("sync"))
    with Timer("stage"):
        pass
    assert calls == (["sync"] if initialised else [])
    with pytest.raises(ValueError):      # a failing stage is not waited on
        with Timer("stage"):
            raise ValueError
    assert calls == (["sync"] if initialised else [])
