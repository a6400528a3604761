"""Where the time goes in the gather-engine refinement loop on one CUDA card.

    python -m pyp_tpu_torch.tools.profile_refine [--out DIR] [--trace 2,3]

Synthesises the slice's dataset (`e2e_spa.SLICE`: 4,096 particles, box
128), then runs the `refine` mode through `pyp_tpu_torch.cli.main` four
times in one project and prints one JSON line per run:

  warm      the first run (first-call costs included), wall per iteration;
  steady    the same run again, wall per iteration;
  layers    each layer (global_search, shift_scored_match, local_refine,
            accumulate, finalize) timed between two synchronises and summed
            per iteration — the synchronises themselves add a little;
  profiled  torch.profiler over the iterations in --trace: device busy time
            (the summed self time of the device's kernels and copies), its
            share of the traced wall and of the steady run's untraced wall
            (the profiler slows the host several-fold, so the first share
            understates how busy the card is), and the top kernels. The
            full tables go to DIR/profile_iter<N>.txt.

The card's name and power limit (nvidia-smi) head the output. Needs a CUDA
card; there is no CPU mode.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from pyp_tpu_torch import cli
from pyp_tpu_torch.ops import reconstruct, refine3d
from pyp_tpu_torch.pipeline import refine as ref_pipe
from pyp_tpu_torch.tools import e2e_spa

LAYERS = ((refine3d, "global_search"), (refine3d, "shift_scored_match"),
          (refine3d, "local_refine"), (reconstruct, "accumulate"),
          (reconstruct, "finalize"))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def _patched(pairs):
    """Temporarily replace module attributes: pairs of (module, name, new)."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in pairs]
    for mod, name, new in pairs:
        setattr(mod, name, new)
    try:
        yield
    finally:
        for mod, name, old in saved:
            setattr(mod, name, old)


def _device_summary(prof, wall_s):
    """Busy time and top kernels from a profile's key averages."""
    from torch.autograd import DeviceType

    ka = prof.key_averages()
    dev_rows = [e for e in ka if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev_rows) / 1e6
    top = sorted(dev_rows, key=lambda e: -e.self_device_time_total)[:10]
    return ka, {
        "wall_s": wall_s, "device_busy_s": busy, "busy_share": busy / wall_s,
        "device_ops": sum(e.count for e in dev_rows),
        "top": [[e.key[:70], e.self_device_time_total / 1e3, e.count]
                for e in top]}


def drive(argv, device, layers=False, trace=(), out_dir=None, header=""):
    """One `refine` run through cli.main in the current directory, maps/
    emptied first. Returns {iteration: row}: wall, FSC(0.143), the
    iteration's device memory peak on CUDA, and layer sums or a profile
    summary where asked. Raises if the CLI fails."""
    dev = torch.device(device)
    shutil.rmtree("maps", ignore_errors=True)
    rows = {}
    current = [None]

    def timed(name, inner):
        def call(*args, **kwargs):
            _sync(dev)
            t0 = time.perf_counter()
            out = inner(*args, **kwargs)
            _sync(dev)
            n_s = rows[current[0]]["layers"].setdefault(name, [0, 0.0])
            n_s[0] += 1
            n_s[1] += time.perf_counter() - t0
            return out
        return call

    inner_iteration = ref_pipe.refinement_iteration

    def iteration(*args, **kwargs):
        it = args[4]
        current[0] = it
        rows[it] = {"layers": {}}
        traced = it in trace
        activities = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof_cm = (torch.profiler.profile(activities=activities) if traced
                   else contextlib.nullcontext())
        _sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with prof_cm as prof:
            out = inner_iteration(*args, **kwargs)
            _sync(dev)
        wall = time.perf_counter() - t0
        rows[it].update(wall_s=wall, fsc143_A=out[2])
        if dev.type == "cuda":
            rows[it]["max_memory_allocated_GiB"] = (
                torch.cuda.max_memory_allocated(dev) / 2**30)
        if traced:
            ka, summary = _device_summary(prof, wall)
            rows[it]["profile"] = summary
            if out_dir is not None:
                (out_dir / f"profile_iter{it}.txt").write_text(
                    f"{header}\niteration {it}: wall {wall:.4f} s, device "
                    f"busy {summary['device_busy_s']:.4f} s\n"
                    + ka.table(sort_by="self_device_time_total",
                               row_limit=50, max_name_column_width=80))
        return out

    pairs = [(ref_pipe, "refinement_iteration", iteration)]
    if layers:
        pairs += [(mod, name, timed(name, getattr(mod, name)))
                  for mod, name in LAYERS]
    with _patched(pairs):
        rc = cli.main(argv, device=device)
    if rc != 0:
        raise RuntimeError(f"pyp_tpu_torch.cli.main returned {rc}")
    for row in rows.values():
        if not row["layers"]:
            del row["layers"]
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="profile_refine_out",
                    help="directory for the profiler tables")
    ap.add_argument("--trace", default="2,3",
                    help="iterations to trace in the profiled run")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_refine needs a CUDA card "
                         "(torch.cuda.is_available() is False)")
    out_dir = Path(args.out).resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    trace = tuple(int(x) for x in args.trace.split(",") if x)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    slice_ = e2e_spa.SLICE
    data = e2e_spa.make_dataset(device="cuda", **slice_)
    init = e2e_spa.starting_map(data["volume"], slice_["pixel"],
                                e2e_spa.START_RESOLUTION)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        e2e_spa.write_project(work, data, init, pixel=slice_["pixel"])
        os.chdir(work)
        try:
            for name, kw in (("warm", {}), ("steady", {}),
                             ("layers", {"layers": True}),
                             ("profiled", {"trace": trace})):
                rows = drive(e2e_spa.REFINE_ARGS, "cuda", out_dir=out_dir,
                             header=smi, **kw)
                if name == "steady":
                    steady = rows
                for it, row in rows.items():
                    if "profile" in row:
                        row["profile"]["busy_share_untraced"] = (
                            row["profile"]["device_busy_s"]
                            / steady[it]["wall_s"])
                print(json.dumps({"run": name, "nvidia_smi": smi,
                                  "iterations": rows}), flush=True)
        finally:
            os.chdir(cwd)


if __name__ == "__main__":
    main()
