"""Smoke run of pyp_tpu_torch on one CUDA card: builds the port's kernels
from the sources in this checkout, checks each against its plain PyTorch
version at the shapes the main path gives it, then drives the main path —
the gather-engine SPA refinement loop through `pyp_tpu_torch.cli.main` —
on a synthetic 4,096-particle, box-128 dataset and checks the result
against the ground truth.

    python3 chip_smoke.py

Prints one JSON line per phase, the card's name and power limit, a
`{"kernels": [...]}` line, and as its last line
`{"ok": true, "device": {...}}`. Any failed phase exits non-zero without
that last line; so does a machine with no CUDA device.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# global-search shapes at the slice's size: 256 particles x 72 psi rows,
# mask points of the 50-12 Å band at box 128 / 1 Å, 7.5° directions,
# +-6 px shifts at 2 px
KERNEL_CASES = [
    ("test_pallas_kernels[0]", 40, 200, 50, 9, 0),
    ("test_pallas_kernels[1]", 13, 37, 5, 3, 1),
    ("test_pallas_kernels[2]", 40, 200, 50, 1, 2),
    ("slice", 256 * 72, 168, 732, 29, 3),
]
RTOL, ATOL_REL, MAX_IDX_DISAGREE = 2e-5, 2e-4, 0.01


def emit(obj):
    print(json.dumps(obj), flush=True)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke "
                           "run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    return smi


def phase_build():
    from pyp_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build("shift_scored_match")
    _build.load("shift_scored_match")
    emit({"phase": "build", "kernel": "shift_scored_match",
          "library": os.path.relpath(path, ROOT),
          "seconds": time.perf_counter() - t0})


def _problem(A, G, D, S, seed):
    import torch

    rng = np.random.RandomState(seed)
    v = (rng.randn(A, G) + 1j * rng.randn(A, G)).astype(np.complex64)
    u = (rng.randn(G, D) + 1j * rng.randn(G, D)).astype(np.complex64)
    E = np.exp(1j * rng.uniform(0, 2 * np.pi, (G, S))).astype(np.complex64)
    ninv = (1.0 / (1.0 + rng.rand(A, D))).astype(np.float32)
    return [torch.from_numpy(x).cuda() for x in (v, u, E, ninv)]


def _median_ms(fn, reps=11):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_kernel():
    import torch

    from pyp_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    slice_row = None
    for name, A, G, D, S, seed in KERNEL_CASES:
        args = _problem(A, G, D, S, seed)
        score, sidx = kernels.shift_scored_match(*args)
        ref_score, ref_idx = kernels.shift_scored_match_plain(*args)
        torch.cuda.synchronize()
        scale = float(ref_score.abs().max())
        err = float((score - ref_score).abs().max())
        ok = bool(torch.allclose(score, ref_score, rtol=RTOL,
                                 atol=ATOL_REL * scale))
        disagree = float((sidx != ref_idx).float().mean())
        row = {"phase": "kernel", "case": name, "A": A, "G": G, "D": D,
               "S": S, "max_abs_err": err, "max_abs_score": scale,
               "idx_disagree": disagree,
               "ms": _median_ms(lambda: kernels.shift_scored_match(*args)),
               "plain_ms": _median_ms(
                   lambda: kernels.shift_scored_match_plain(*args)),
               "ok": ok and disagree < MAX_IDX_DISAGREE}
        emit(row)
        if not row["ok"]:
            raise RuntimeError(f"shift_scored_match disagrees with its plain "
                               f"version on case {name}: {row}")
        if name == "slice":
            slice_row = row
        del args
    return slice_row


def phase_slice():
    import torch

    from pyp_tpu.io import cistem, mrc
    from pyp_tpu_torch.ops import kernels
    from pyp_tpu_torch.tools import e2e_spa, profile_refine
    from pyp_tpu_torch.tools.e2e_spa import REFINE_ARGS, SLICE

    t0 = time.perf_counter()
    data = e2e_spa.make_dataset(device="cuda", **SLICE)
    init = e2e_spa.starting_map(data["volume"], SLICE["pixel"],
                                e2e_spa.START_RESOLUTION)
    emit({"phase": "synthesize", "seconds": time.perf_counter() - t0,
          "n_particles": SLICE["n_particles"], "box": SLICE["box"]})

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        e2e_spa.write_project(work, data, init, pixel=SLICE["pixel"])
        os.chdir(work)
        kernels.shift_scored_match.launches = 0
        try:
            # pyp_tpu_torch.cli.main(REFINE_ARGS, device="cuda"), with each
            # iteration's wall, FSC(0.143) and device memory peak recorded
            t0 = time.perf_counter()
            iters = profile_refine.drive(REFINE_ARGS, "cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            launches = kernels.shift_scored_match.launches
            os.chdir(cwd)
        for it, row in iters.items():
            emit({"phase": "iteration", "iteration": it, **row})
        if sorted(iters) != [2, 3, 4]:
            raise RuntimeError(f"expected iterations 2-4, ran {sorted(iters)}")
        # iterations 2 (global) .. refine_maxiter + 1 (local)
        stem = os.path.join(work, "maps", "dataset_r01_04")
        table = cistem.read_parameters(stem + ".cistem")
        final = mrc.read(stem + ".mrc")
    box = SLICE["box"]
    if final.shape != (box, box, box) or not np.isfinite(final).all():
        raise RuntimeError(f"final map has shape {final.shape} or "
                           "non-finite values")
    err = e2e_spa.angular_error_deg(table["phi"], table["theta"],
                                    table["psi"], data)
    cc0 = e2e_spa.masked_cc(init, data["volume"], SLICE["pixel"], 10.0)
    cc1 = e2e_spa.masked_cc(final, data["volume"], SLICE["pixel"], 10.0)
    row = {"phase": "slice", "seconds": wall, "launches": launches,
           "median_angular_error_deg": float(np.median(err)),
           "frac_within_5deg": float((err < 5).mean()),
           "cc_start_10A": cc0, "cc_final_10A": cc1,
           "final_fsc143_A": iters[4]["fsc143_A"],
           "particles_per_s": SLICE["n_particles"] * 3 / wall}
    emit(row)
    if launches <= 0:
        raise RuntimeError("the main path never launched shift_scored_match")
    if not row["median_angular_error_deg"] < 10.0:
        raise RuntimeError(f"median angular error {row['median_angular_error_deg']:.2f}° "
                           "is not under 10°")
    if not cc1 > cc0:
        raise RuntimeError(f"final cc {cc1:.4f} is not above the starting "
                           f"map's {cc0:.4f}")
    return launches


def main():
    import torch

    smi = phase_device()
    phase_build()
    k = phase_kernel()
    launches = phase_slice()
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "shift_scored_match", "route": "cuda",
        "source": "pyp_tpu_torch/csrc/shift_scored_match.cu",
        "replaces": "pyp_tpu/ops/pallas_kernels.py:80",
        "launches": launches, "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
