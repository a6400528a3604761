"""BENCHMARK.json keeps to the benchmark's contract, every cell resolves by
name to files that exist, and a new cell, configuration, mix or metric is
found from new files alone."""

import importlib
import json
import re
import shutil
from pathlib import Path

import pytest

from portbench.lib import registry

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entries():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["source"].startswith("https://")
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    everything = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for entry in everything:
        assert NAME.match(entry["name"])
        assert "unit" not in entry or UNIT.match(entry["unit"])
        assert "better" not in entry or entry["better"] in ("lower", "higher")
    names = [e["name"] for e in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_resolves_and_reports_enough(name):
    cell = registry.Cell(name)
    e2e = {m["name"] for m in cell.end_to_end()}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer()
    assert cell.config["name"] == cell.entry["config"]
    mod = cell.unit_module()
    assert mod.RATE in e2e and hasattr(mod, "Unit") and mod.LAYERS
    for m in cell.per_layer():
        assert callable(registry.metric_reader(m["name"]))
        assert m["moves"] in e2e
    for module, attr, _ in mod.LAYERS:
        assert hasattr(importlib.import_module(module), attr), (module, attr)
    assert set(cell.limits) and all(v > 0 for v in cell.limits.values())


def test_a_new_cell_config_mix_and_metric_are_found_by_name(tmp_path):
    bench = tmp_path / "portbench"
    for d in ("configs", "traffic", "workloads", "metrics", "counts"):
        shutil.copytree(ROOT / "portbench" / d, bench / d)
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((bench / "configs" / "csp_bench_8x41x128_box64.json").read_text())
    cfg["name"] = "csp_box96"
    cfg["box"] = 96
    (bench / "configs" / "csp_box96.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "csp_modes.json").read_text())
    mix["iters_per_mode"] = 10
    (bench / "traffic" / "csp_modes_x10.json").write_text(json.dumps(mix))
    (bench / "workloads" / "csp_box96.x10.json").write_text(json.dumps(
        {"config": "csp_box96", "traffic": "csp_modes_x10", "chips": 1,
         "why": "w", "limits": {"acc_rel_err": 1e-4}}))
    (bench / "metrics" / "gather_ms.py").write_text(
        "from portbench.lib.readers import range_ms\n\n\n"
        "def read(ctx):\n    return range_ms(ctx, 'csp._csp_model_gather')\n")
    doc["configs"].append({"name": "csp_box96", "source": "https://x.org",
                           "file": "portbench/configs/csp_box96.json",
                           "reduced": [], "why": "w"})
    doc["workloads"].append({"name": "csp_box96.x10", "config": "csp_box96",
                             "traffic": "csp_modes_x10", "chips": 1, "why": "w"})
    doc["end_to_end"][0]["workloads"].append("csp_box96.x10")
    doc["per_layer"].append({"name": "gather_ms", "unit": "ms", "better": "lower",
                             "source": "device_trace", "layer": "CSP refinement",
                             "moves": "csp_projections_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    cell = registry.Cell("csp_box96.x10", root=tmp_path, bench_dir=bench)
    assert cell.config["box"] == 96
    assert cell.traffic["iters_per_mode"] == 10
    assert cell.unit_module().RATE == "csp_projections_per_s"
    names = {m["name"] for m in cell.per_layer()}
    assert "gather_ms" in names and "csp_refine_ms" not in names
    # a metric without a cell list is reported by every cell of its metric
    assert "gather_ms" in {m["name"] for m in registry.Cell(
        "csp_modes", root=tmp_path, bench_dir=bench).per_layer()}
    reader = registry.metric_reader("gather_ms", bench)
    ctx = {"trace": {"per_range_s": {"csp._csp_model_gather": 0.5}}, "units": 2}
    assert reader(ctx) == pytest.approx(250.0)


def test_a_workload_file_that_disagrees_is_refused(tmp_path):
    bench = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench" / "workloads", bench / "workloads")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    w = json.loads((bench / "workloads" / "csp_modes.json").read_text())
    w["traffic"] = "csp_modes_x10"
    (bench / "workloads" / "csp_modes.json").write_text(json.dumps(w))
    with pytest.raises(ValueError):
        registry.Cell("csp_modes", root=tmp_path, bench_dir=bench)
