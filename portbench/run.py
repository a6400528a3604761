#!/usr/bin/env python3
"""The benchmark of pyp_tpu_torch on NVIDIA cards: one cell, one run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The run makes the cell's inputs from the seed
on the card, builds the system's state and runs one unit to warm every shape
(set-up), then starts units until `--seconds` have passed and lets the last
one finish (the window). `--trace 0` reports the cell's end-to-end metrics.
`--trace 1` runs the same window in which two profiled stretches follow one
another, each over the units that start in its first TRACE_S seconds: the
busy window, profiling CUDA activity alone, gives the device's busy and idle
time; the attribution window, profiling host and CUDA activity with a range
around each call into the system's layers, gives each layer's device time
per unit, the rooflines and the breakdown.
After the window the system's state is freed and the plain reference
judges what the last unit produced (`correct`).

Earlier output lines: the card and its power limit, the system's kernel
launches, the per-layer breakdown. The last lines of standard error are the
numbers compared, each beside its limit; the last line of standard output
is the result, one JSON object. Exits 2 without a card, or with fewer cards
than the cell asks for, and 3 when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".portbench_cache"
FORBIDDEN = {"jax", "jaxlib", "flax", "pyp_tpu"}
TRACE_S = 15.0     # each profiled stretch of a traced run: the units that start in its first TRACE_S


def process_age_s():
    """Seconds since this process started (Linux /proc), else since import."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
        return out.splitlines()[0] if out else "nvidia-smi gave nothing"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def launches():
    from pyp_tpu_torch.ops import kernels

    return {"shift_scored_match": int(getattr(kernels.shift_scored_match,
                                              "launches", 0))}


def run_cell(cell, seed, seconds, traced, dev):
    """Set-up, window and judgment of one run of `cell` on `dev`. Returns
    (the result, the top-level names of JAX modules that were loaded)."""
    import torch

    from portbench.lib import registry, trace

    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def peak():
        return torch.cuda.max_memory_allocated(dev) if cuda else 0

    mod = cell.unit_module()
    unit = mod.Unit(cell.config, cell.traffic, seed, dev)
    unit.run()                          # warm every shape of the cell
    sync()
    setup_s = process_age_s()
    peak_setup = peak()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    before = launches()
    # a traced run's stretches: the busy window, then the attribution window
    stretches = ["busy", "attribution"] if traced else []
    stack = None
    busy = summary = None
    t0 = time.perf_counter()
    units = 0
    while True:
        if stack is None and stretches:
            stack = contextlib.ExitStack()
            if stretches[0] == "busy":
                prof = stack.enter_context(trace.profiled(host=False))
            else:
                ranges = stack.enter_context(trace.Ranges(mod.LAYERS))
                prof = stack.enter_context(trace.profiled(host=True))
                stack.enter_context(torch.profiler.record_function(
                    trace.PREFIX + trace.WINDOW))
            s0, u0 = time.perf_counter(), units
        unit.run()
        sync()
        units += 1
        now = time.perf_counter() - t0
        if stack is not None and time.perf_counter() - s0 >= min(seconds, TRACE_S):
            span = time.perf_counter() - s0
            stack.close()                   # the profiler stops here
            stack, kind = None, stretches.pop(0)
            t_read = time.perf_counter()
            if kind == "busy":
                busy_s, n = trace.busy_seconds(prof)
                busy = {"busy_s": busy_s, "window_s": span}
            else:
                summary = trace.read_trace(prof)
                traced_units = units - u0
            prof = None
            print(json.dumps({"stretch": kind, "units": units - u0, "seconds": span,
                              "stop_and_read_s": time.perf_counter() - t_read}),
                  flush=True)
        if now >= seconds and not stretches and stack is None:
            break
    elapsed = time.perf_counter() - t0
    peak_window = peak()
    after = launches()
    print(json.dumps({"launches_in_window": {
        k: after[k] - before[k] for k in after}, "units": units,
        "window_s": elapsed}), flush=True)
    device = {"platform": "gpu" if cuda else dev.type,
              "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
              "count": cell.chips,
              "memory_peak_bytes": max(peak_setup, peak_window)}
    metrics = {}
    breakdown = None
    if traced:
        ctx = {"trace": summary, "busy": busy, "calls": ranges.calls,
               "units": traced_units, "peak_window_bytes": peak_window}
        for m in cell.per_layer():
            value = registry.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device["busy_s"] = busy["busy_s"]
        device["window_s"] = busy["window_s"]
        breakdown = {"device_ops": summary["device_ops"],
                     "idle_gaps": summary["idle_gaps"]}
        print(json.dumps({
            "per_range_s": summary["per_range_s"],
            "of_which_launched_from_another_thread_s": summary["other_thread_s"],
            "calls": {k: len(v) for k, v in ranges.calls.items()},
            "attribution_window": {"busy_s": summary["busy_s"],
                                   "window_s": summary["window_s"],
                                   "device_events": summary["n_device_events"]},
            "busy_window_device_events": n}), flush=True)
    else:
        rates = {mod.RATE: units * unit.work / elapsed, "setup_s": setup_s}
        for m in cell.end_to_end():
            metrics[m["name"]] = {"value": rates[m["name"]], "unit": m["unit"]}
    print(json.dumps({"metrics": metrics}), flush=True)
    unit.release()
    if cuda:
        torch.cuda.empty_cache()
    numbers = unit.judge()
    checks = {k: {"value": v, "limit": cell.limits[k]} for k, v in numbers.items()}
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": units, "failed": 0, "metrics": metrics,
              "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    loaded = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    return result, loaded


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "portbench"]
    sys.path.insert(0, str(ROOT))
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)

    from portbench.lib import registry

    cell = registry.Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA card(s); found {n}",
              file=sys.stderr)
        return 2
    print(json.dumps({"card": card_line(), "workload": cell.name,
                      "seed": args.seed}), flush=True)
    result, loaded = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0))
    if loaded:
        print(f"modules of JAX or the JAX package were loaded: {loaded}",
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
