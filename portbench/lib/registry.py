"""Finds everything by name: a cell's workload file, its configuration, its
traffic mix, the unit module the mix names, the metrics the cell reports and
their readers, and the count functions of kernels.

    BENCHMARK.json                  the cells, metrics and bounds
    portbench/workloads/<cell>.json config, traffic, chips, why, limits
    portbench/configs/<config>.json the deployment's sizes and source
    portbench/traffic/<traffic>.json the mix: its kind of unit and parameters
    portbench/units/<unit>.py       one module per kind of unit
    portbench/metrics/<metric>.py   one reader per per-layer metric
    portbench/counts/<kernel>.py    operations and bytes from shapes

A new cell, configuration, mix or metric is new files and new entries:
nothing here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]     # portbench/
ROOT = HERE.parent


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """One cell of the benchmark, resolved from its name."""

    def __init__(self, name, root=ROOT, bench_dir=HERE):
        self.name = name
        self.bench = load_json(Path(root) / "BENCHMARK.json")
        entries = {w["name"]: w for w in self.bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = entries[name]
        self.spec = load_json(Path(bench_dir) / "workloads" / f"{name}.json")
        for key in ("config", "traffic", "chips"):
            if self.spec[key] != self.entry[key]:
                raise ValueError(f"{name}: {key} {self.spec[key]!r} in its "
                                 f"workload file, {self.entry[key]!r} in "
                                 "BENCHMARK.json")
        self.config = load_json(Path(bench_dir) / "configs" / f"{self.spec['config']}.json")
        self.traffic = load_json(Path(bench_dir) / "traffic" / f"{self.spec['traffic']}.json")
        self.limits = self.spec["limits"]
        self.chips = int(self.entry["chips"])

    def unit_module(self):
        return importlib.import_module(f"portbench.units.{self.traffic['unit']}")

    def end_to_end(self):
        """The end-to-end metrics this cell reports."""
        return [m for m in self.bench["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self):
        """The per-layer metrics this cell reports: those that list it, and
        those without a list that move an end-to-end metric it reports."""
        mine = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in mine)]


def load_file(path):
    """A module from a file whose name may hold dots (insertion_ms.csp.py)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name, bench_dir=HERE):
    return load_file(Path(bench_dir) / "metrics" / f"{name}.py").read


def counts(kernel, bench_dir=HERE):
    return load_file(Path(bench_dir) / "counts" / f"{kernel}.py")
