"""Test set-up of the benchmark's CPU tests: the repository root on the path,
few threads, and small copies of the cells (`tiny_cell`)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BENCH = ROOT / "portbench"

# Sizes at which a unit runs on a CPU in seconds and the refinement still
# converges, with limits for these sizes.
TINY = {
    "csp_modes": {
        "config": {"series": 2, "tilts": 9, "particles_per_series": 8,
                   "box": 16, "pixel": 4.0},
        "traffic": {},
        "limits": {"acc_rel_err": 5e-4, "csp_score_loss": 0.3},
    },
}


def tiny_cell(tmp, name):
    """A copy of the benchmark's files in `tmp` with the cell `name` cut to
    its TINY size, resolved by name."""
    from portbench.lib import registry

    tmp = Path(tmp)
    bench = tmp / "portbench"
    for d in ("configs", "traffic", "workloads", "metrics", "counts"):
        shutil.copytree(BENCH / d, bench / d, dirs_exist_ok=True)
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    t = TINY[name]

    def update(path, fn):
        data = json.loads(path.read_text())
        fn(data)
        path.write_text(json.dumps(data))

    w = json.loads((bench / "workloads" / f"{name}.json").read_text())
    update(bench / "configs" / f"{w['config']}.json",
           lambda c: c.update(t["config"]))
    update(bench / "traffic" / f"{w['traffic']}.json",
           lambda m: m.update(t["traffic"]))
    update(bench / "workloads" / f"{name}.json",
           lambda m: m.update(limits=t["limits"]))
    return registry.Cell(name, root=tmp, bench_dir=bench)


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
