#!/usr/bin/env python3
"""The system's own spans read beside the benchmark's ranges, on the card.

    python3 portbench/span_readings.py --workload <cell> --seeds 11,12,... [--units 6] [--out FILE]

For each seed: one process-local set-up of the cell and one warm unit, then
`--units` units in one profile of host and CUDA activity with the
benchmark's ranges open, as the attribution window of a traced run, read by
`lib/spans.read_trace`. One JSON line per seed (with --out also appended to
FILE): the per-layer readings of the spans (`spans.READINGS`); each span's
twin range beside it (device ms a unit); the share of `pyp::csp.refine_batch`
that the mode loop's own spans cover; every span's device ms a unit, count,
launches and idle ms a unit; the idle gaps named by the innermost range or
span; and whether `trace.read_trace` reads every range as the widened
reader does. Not run by the benchmark's runs.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# the benchmark's range (trace.Ranges label) -> the system's span of the same call
TWINS = {"csp.csp_refine_batch": "pyp::csp.refine_batch",
         "csp._csp_model_gather": "pyp::csp.gather",
         "reconstruct.accumulate_matrices": "pyp::reconstruct.accumulate_matrices"}
# the spans that hold the mode loop's work, side by side inside pyp::csp.refine_batch
LOOP = ("pyp::csp.mode.start", "pyp::csp.step", "pyp::csp.mode.keep",
        "pyp::csp.scores")


def reading(prof, units):
    """The JSON-ready numbers of one finished profile over `units` units."""
    from portbench.lib import spans, trace

    old, t = trace.read_trace(prof), spans.read_trace(prof)
    ms = {k: 1e3 * v / units for k, v in t["per_range_s"].items()}
    whole = ms.get("pyp::csp.refine_batch")
    labels = [k for k in t["range_count"] if k.startswith(spans.SPAN)]
    ctx = {"trace": t, "units": units}
    same = {k: old[k] == t[k] for k in ("window_s", "busy_s", "device_ops",
                                        "n_device_events")}
    for k in ("per_range_s", "other_thread_s"):
        same[k] = all(t[k].get(r) == v for r, v in old[k].items()
                      if r != spans.OUTSIDE)
    return {
        "units": units,
        "readings": {k: r(ctx) for k, (_, r) in spans.READINGS.items()},
        "twins_ms": {r: [ms.get(r), ms.get(s)] for r, s in TWINS.items()},
        "loop_cover": (sum(ms.get(k, 0.0) for k in LOOP) / whole
                       if whole else None),
        "spans": {k: {"ms": ms.get(k, 0.0), "count": t["range_count"][k],
                      "launches": t["launches_in"].get(k, 0),
                      "other_thread_ms": 1e3 * t["other_thread_s"].get(k, 0.0) / units,
                      "idle_ms": 1e3 * t["idle_in_s"].get(k, 0.0) / units}
                  for k in sorted(labels)},
        "idle_gaps": t["idle_gaps"],
        "benchmark_idle_gaps": old["idle_gaps"],
        "window_s": t["window_s"], "busy_s": t["busy_s"],
        "read_trace_agrees": same,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--units", type=int, default=6)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.lib import registry, trace

    if not torch.cuda.is_available():
        print("span readings need a CUDA card", file=sys.stderr)
        return 2
    cell = registry.Cell(args.workload)
    mod = cell.unit_module()
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        unit = mod.Unit(cell.config, cell.traffic, seed, dev)
        unit.run()
        torch.cuda.synchronize(dev)
        with trace.Ranges(mod.LAYERS), trace.profiled(host=True) as prof:
            with torch.profiler.record_function(trace.PREFIX + trace.WINDOW):
                for _ in range(args.units):
                    unit.run()
                    torch.cuda.synchronize(dev)
        line = json.dumps({"workload": cell.name, "seed": seed,
                           **reading(prof, args.units)})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del unit, prof
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
