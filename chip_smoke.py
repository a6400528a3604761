"""Smoke run of pyp_tpu_torch on one CUDA card: builds the port's kernels
from the sources in this checkout, checks each against its plain PyTorch
version at the shapes the main path gives it, then drives the SPA
refinement loop through `pyp_tpu_torch.cli.main` on a synthetic
4,096-particle, box-128 dataset, once per engine, and checks each result
against the ground truth:

  slice      the gather engine (the path of the shift_scored_match kernel);
  frm_polar  one FRM batch with the matmul and the gather polar sampler;
  frm_slice  the reference's FRM protocol (the default engine, gold-
             standard half banks, final polish), held to the reference's
             quality: FSC(0.143) <= 4.86 Å, masked 10 Å cc vs truth
             >= 0.94, median angular error < 1°;
  frm_options  the same protocol with every reconstruction option of the
             loop on (final B-factor sharpening, matching projections,
             model fitting against a pseudo-atom PDB of the truth,
             likelihood blurring, reference-based Ewald insertion, score
             shaping), held to its files and the masked cc >= 0.94;
  postprocess  the `postprocess` (with local resolution), `mask` and
             `fsc` modes on frm_slice's final half maps, held to a masked
             FSC no coarser than the unmasked one plus a shell, a negative
             B and a median local resolution inside [2 px, 20 Å].

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

# (name, A, G, D, S, seed); the last is the global search at the slice's
# size: 256 particles x 72 psi rows, mask points of the 50-12 Å band at
# box 128 / 1 Å, 7.5° directions, +-6 px shifts at 2 px
KERNEL_CASES = [
    ("test_pallas_kernels[0]", 40, 200, 50, 9, 0),
    ("test_pallas_kernels[1]", 13, 37, 5, 3, 1),
    ("test_pallas_kernels[2]", 40, 200, 50, 1, 2),
    ("shift_chunks", 300, 64, 40, 49, 4),   # S > 32: two chunks of 25
    ("ragged", 1000, 37, 13, 7, 5),         # G % 4 != 0, D % 8 != 0
    ("slice", 256 * 72, 168, 732, 29, 3),
]
RTOL, ATOL_REL, MAX_IDX_DISAGREE = 2e-5, 2e-4, 0.01
# the H100 SXM's published peaks (NVIDIA's data sheet, 700 W): dense TF32
# on the tensor cores, FP32 on the CUDA cores, HBM3 bandwidth
TF32_FLOPS, FP32_FLOPS, HBM_BYTES_S = 495e12, 67e12, 3.35e12


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


def library_call(v, u, E, ninv):
    """The yardstick (never called by the port): one FP32 SGEMM
    (A, 2G) x (2G, S*D), TF32 off, with the shift-folded B' built from u
    and E, then the max over S (`torch.max` returns the first maximum)."""
    import torch

    w = E[:, :, None] * u[:, None, :]                      # (G, S, D)
    bk = torch.cat([w.real, -w.imag]).flatten(1)           # (2G, S*D)
    num = torch.cat([v.real, v.imag], 1) @ bk              # (A, S*D)
    best, idx = (num.view(len(v), E.shape[1], -1) * ninv[:, None]).max(1)
    return best, idx.to(torch.int32)


def bounds_ms(A, G, D, S):
    """(3xTF32 bound, FP32 bound, memory bound) in ms: the function's
    4*A*D*S*G FLOP three times over at the TF32 tensor-core peak, once at
    the FP32 peak, and its bytes (v, u, E, ninv read once; score and sidx
    written once) at the HBM rate."""
    flop = 4.0 * A * D * S * G
    nbytes = 8 * (A * G + G * D + G * S) + 4 * A * D + 8 * A * D
    return (1e3 * 3 * flop / TF32_FLOPS, 1e3 * flop / FP32_FLOPS,
            1e3 * nbytes / HBM_BYTES_S)


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
        if S == 1:
            ok = ok and bool((sidx == 0).all())
        row = {"phase": "kernel", "case": name, "A": A, "G": G, "D": D,
               "S": S, "max_abs_err": err, "max_abs_score": scale,
               "idx_disagree": disagree,
               "ok": ok and disagree < MAX_IDX_DISAGREE}
        if name == "slice":
            tf32x3, fp32, mem = bounds_ms(A, G, D, S)
            operands = kernels.kernel_operands(*args[:3])
            lib_score, _ = library_call(*args)
            torch.cuda.synchronize()
            row.update(
                ms=_median_ms(lambda: kernels.shift_scored_match(*args)),
                layout_ms=_median_ms(
                    lambda: kernels.kernel_operands(*args[:3])),
                kernel_ms=_median_ms(lambda: kernels.launch_kernel(
                    operands, args[3], S)),
                plain_ms=_median_ms(
                    lambda: kernels.shift_scored_match_plain(*args)),
                library_ms=_median_ms(lambda: library_call(*args)),
                library_max_abs_err=float((lib_score - ref_score).abs().max()),
                bound_ms=tf32x3, bound_fp32_ms=fp32, bound_bytes_ms=mem)
            row.update(tflops=4.0 * A * D * S * G / row["ms"] / 1e9,
                       share_of_bound=tf32x3 / row["ms"],
                       kernel_share_of_bound=tf32x3 / row["kernel_ms"],
                       share_of_fp32_bound=fp32 / row["ms"])
            slice_row = row
            del operands
        emit(row)
        if not row["ok"]:
            raise RuntimeError(f"shift_scored_match disagrees with its plain "
                               f"version on case {name}: {row}")
        del args
    return slice_row


def phase_synthesize():
    from pyp_tpu_torch.tools import e2e_spa
    from pyp_tpu_torch.tools.e2e_spa import SLICE

    t0 = time.perf_counter()
    data = e2e_spa.make_dataset(device="cuda", **SLICE)
    init = e2e_spa.starting_map(data["volume"], SLICE["pixel"],
                                e2e_spa.START_RESOLUTION)
    emit({"phase": "synthesize", "seconds": time.perf_counter() - t0,
          "n_particles": SLICE["n_particles"], "box": SLICE["box"]})
    return data, init


def _drive_protocol(argv, data, init, inspect=None):
    """pyp_tpu_torch.cli.main(argv, device="cuda") in a fresh project,
    with each iteration's wall, FSC(0.143) and device memory peak
    recorded. Returns (iterations, final table, final map, wall, kernel
    launches during the run, inspect(maps dir, final stem) or None)."""
    import torch

    from pyp_tpu_torch.io import cistem, mrc
    from pyp_tpu_torch.ops import kernels
    from pyp_tpu_torch.tools import e2e_spa, profile_refine
    from pyp_tpu_torch.tools.e2e_spa import SLICE

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        e2e_spa.write_project(work, data, init, pixel=SLICE["pixel"])
        os.chdir(work)
        kernels.shift_scored_match.launches = 0
        try:
            t0 = time.perf_counter()
            iters = profile_refine.drive(argv, "cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            launches = kernels.shift_scored_match.launches
            os.chdir(cwd)
        last = max(iters)
        stem = os.path.join(work, "maps", f"dataset_r01_{last:02d}")
        table = cistem.read_parameters(stem + ".cistem")
        final = mrc.read(stem + ".mrc")
        extra = inspect(os.path.join(work, "maps"), stem) if inspect else None
    for it, row in iters.items():
        emit({"phase": "iteration", "argv": argv[1:3], "iteration": it, **row})
    box = SLICE["box"]
    if final.shape != (box, box, box) or not np.isfinite(final).all():
        raise RuntimeError(f"final map has shape {final.shape} or "
                           "non-finite values")
    return iters, table, final, wall, launches, extra


def _quality(table, final, data, init):
    from pyp_tpu_torch.tools import e2e_spa
    from pyp_tpu_torch.tools.e2e_spa import SLICE

    err = e2e_spa.angular_error_deg(table["phi"], table["theta"],
                                    table["psi"], data)
    return {"median_angular_error_deg": float(np.median(err)),
            "frac_within_5deg": float((err < 5).mean()),
            "cc_start_10A": e2e_spa.masked_cc(init, data["volume"],
                                              SLICE["pixel"], 10.0),
            "cc_final_10A": e2e_spa.masked_cc(final, data["volume"],
                                              SLICE["pixel"], 10.0)}


def phase_slice(data, init):
    """The gather-engine protocol: the path of the shift_scored_match
    kernel."""
    from pyp_tpu_torch.tools.e2e_spa import REFINE_ARGS, SLICE

    iters, table, final, wall, launches, _ = _drive_protocol(
        REFINE_ARGS, data, init)
    if sorted(iters) != [2, 3, 4]:
        raise RuntimeError(f"expected iterations 2-4, ran {sorted(iters)}")
    row = {"phase": "slice", "seconds": wall, "launches": launches,
           **_quality(table, final, data, init),
           "final_fsc143_A": iters[4]["fsc143_A"],
           "particles_per_s": SLICE["n_particles"] * 3 / wall}
    emit(row)
    if launches <= 0:
        raise RuntimeError("the main path never launched shift_scored_match")
    if not row["median_angular_error_deg"] < 10.0:
        raise RuntimeError(f"median angular error {row['median_angular_error_deg']:.2f}° "
                           "is not under 10°")
    if not row["cc_final_10A"] > row["cc_start_10A"]:
        raise RuntimeError(f"final cc {row['cc_final_10A']:.4f} is not above "
                           f"the starting map's {row['cc_start_10A']:.4f}")
    return launches


def _sync_s(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


FRM_POLAR_SLACK_DEG = 5.5


def phase_frm_polar(data):
    """One FRM batch (256 particles) at the global iteration's shape and
    config (box 128, 50-9.6 Å band, 7.5° lattice, +-6 px at 0.5 px) with
    the matmul sampler and with the gather sampler forced, against the
    true map. Bar (tests/test_frm.py::TestPolarGather): the gather
    sampler's median angular error is at most 5.5° above the matmul
    sampler's."""
    import torch

    from pyp_tpu_torch.ops import frm
    from pyp_tpu_torch.ops.fourier_slice import volume_to_fourier
    from pyp_tpu_torch.tools import e2e_spa
    from pyp_tpu_torch.tools.e2e_spa import SLICE

    B = 256
    xs = torch.from_numpy(data["stack"][:B]).cuda()
    cp = torch.from_numpy(data["ctf_params"][:B]).cuda()
    truth = {k: data[k][:B] for k in ("phi", "theta", "psi")}
    F = volume_to_fourier(torch.from_numpy(data["volume"]).cuda())
    saved = os.environ.get("PYP_TPU_FRM_POLAR")
    meds, poses_by = {}, {}
    try:
        for mode in ("matmul", "gather"):
            os.environ["PYP_TPU_FRM_POLAR"] = mode
            cfg = frm.FrmConfig(
                SLICE["box"], SLICE["pixel"], low_res=50.0, high_res=9.6,
                angular_step=7.5, shift_extent=6.0, shift_step=0.5,
                wiener=0.1, device="cuda")
            if cfg.polar_gather != (mode == "gather"):
                raise RuntimeError(f"PYP_TPU_FRM_POLAR={mode} was not honoured")
            bank, bank_s = _sync_s(lambda: cfg.bank(F))
            (poses, _), first_s = _sync_s(
                lambda: frm.frm_refine(xs, cp, None, cfg, bank=bank))
            match_s = statistics.median(_sync_s(
                lambda: frm.frm_refine(xs, cp, None, cfg, bank=bank))[1]
                for _ in range(3))
            p = poses_by[mode] = poses.cpu().numpy()
            err = e2e_spa.angular_error_deg(p[:, 0], p[:, 1], p[:, 2], truth)
            meds[mode] = float(np.median(err))
            same = np.all(np.abs(p - poses_by["matmul"]) < 1e-3, axis=1)
            emit({"phase": "frm_polar", "sampler": mode, "batch": B,
                  "poses_equal_to_matmul": float(same.mean()),
                  "directions": int(bank.FUc.shape[0]),
                  "rings": int(bank.FUc.shape[1]), "n_psi": cfg.n_psi,
                  "crop": cfg.n, "median_angular_error_deg": meds[mode],
                  "bank_build_s": bank_s, "match_first_s": first_s,
                  "match_s": match_s,
                  "max_memory_allocated_GiB":
                      torch.cuda.max_memory_allocated() / 2**30})
            del bank
    finally:
        if saved is None:
            os.environ.pop("PYP_TPU_FRM_POLAR", None)
        else:
            os.environ["PYP_TPU_FRM_POLAR"] = saved
    if not meds["gather"] <= meds["matmul"] + FRM_POLAR_SLACK_DEG:
        raise RuntimeError(f"gather sampler median error {meds['gather']:.2f}° "
                           f"is more than {FRM_POLAR_SLACK_DEG}° above the "
                           f"matmul sampler's {meds['matmul']:.2f}°")


# the reference's 4,096 x box-128 FRM protocol reached FSC(0.143) 4.68 Å
# and cc 0.946 against the truth (docs/BENCH_E2E.md:131-135); 4.86 Å is
# one Fourier shell (1/128 px^-1) coarser than 4.68 Å
FRM_FSC_BAR_A, FRM_CC_BAR, FRM_ERR_BAR_DEG = 4.86, 0.94, 1.0


def phase_frm_slice(data, init):
    """The reference protocol (e2e_spa.FRM_ARGS): iteration 2 global,
    3-4 local with gold-standard half banks, 5 final with the polish."""
    from pyp_tpu_torch.tools.e2e_spa import FRM_ARGS, SLICE

    def halves(maps, stem):
        from pyp_tpu_torch.io import mrc

        return tuple(mrc.read(f"{stem}_{h}.mrc") for h in ("half1", "half2"))

    iters, table, final, wall, launches, final_halves = _drive_protocol(
        FRM_ARGS, data, init, inspect=halves)
    if sorted(iters) != [2, 3, 4, 5]:
        raise RuntimeError(f"expected iterations 2-5, ran {sorted(iters)}")
    row = {"phase": "frm_slice", "seconds": wall,
           "shift_scored_match_launches": launches,
           **_quality(table, final, data, init),
           "final_fsc143_A": iters[5]["fsc143_A"],
           "particles_per_s": SLICE["n_particles"] * 4 / wall}
    emit(row)
    if launches:
        raise RuntimeError("the FRM protocol launched the gather engine's "
                           "kernel: the engine was switched")
    if not row["final_fsc143_A"] <= FRM_FSC_BAR_A:
        raise RuntimeError(f"final FSC(0.143) {row['final_fsc143_A']:.2f} Å "
                           f"is not <= {FRM_FSC_BAR_A} Å")
    if not row["cc_final_10A"] >= FRM_CC_BAR:
        raise RuntimeError(f"cc vs truth {row['cc_final_10A']:.4f} is not "
                           f">= {FRM_CC_BAR}")
    if not row["median_angular_error_deg"] < FRM_ERR_BAR_DEG:
        raise RuntimeError(f"median angular error {row['median_angular_error_deg']:.3f}° "
                           f"is not under {FRM_ERR_BAR_DEG}°")
    return final_halves


# each iteration's PDB fit of the final map; the pseudo-atom model is the
# densest 1/32 of the truth's voxels
MODEL_CC_BAR, OPTIONS_CC_BAR = 0.5, 0.94
OPTION_FLAGS = ["-reconstruct_fbfact", "-refine_fmatch", "-reconstruct_lblur",
                "-reconstruct_iewald", "2", "-reconstruct_score_fraction",
                "0.9"]


def phase_frm_options(data, init):
    """FRM_ARGS with every reconstruction option of the loop on, through
    cli.main: the final map finite, `_sharp.mrc` written from a negative
    Guinier B, `_match.mrc` of 4,096 128² projections, one
    `_model_fit.txt` line per iteration with the last cc >= 0.5, and the
    final map's masked 10 Å cc vs truth >= 0.94. The final FSC(0.143) is
    reported without a bar: likelihood blurring blurs by design."""
    import torch

    from pyp_tpu_torch.analysis.modelfit import model_map_fit
    from pyp_tpu_torch.io import mrc
    from pyp_tpu_torch.io.pdb import read_pdb
    from pyp_tpu_torch.ops import reconstruct as rec
    from pyp_tpu_torch.postprocess.core import guinier_bfactor
    from pyp_tpu_torch.tools import e2e_spa
    from pyp_tpu_torch.tools.e2e_spa import FRM_ARGS, SLICE

    box, pixel = SLICE["box"], SLICE["pixel"]
    with tempfile.TemporaryDirectory() as tmp:
        pdb = e2e_spa.write_pseudo_atom_pdb(data["volume"], pixel,
                                            box ** 3 // 32,
                                            os.path.join(tmp, "model.pdb"))
        model = read_pdb(pdb)

        def outputs(maps, stem):
            hdr = mrc.read_header(os.path.join(maps, "dataset_match.mrc"))
            with open(os.path.join(maps, "dataset_model_fit.txt")) as f:
                fit_lines = [ln.split() for ln in f if ln.strip()]
            sharp = mrc.read(stem + "_sharp.mrc")
            return {"match_shape": [hdr.nz, hdr.ny, hdr.nx],
                    "model_fit": fit_lines,
                    "sharp_finite": bool(np.isfinite(sharp).all()),
                    "sharp_differs": bool(np.abs(sharp - mrc.read(stem + ".mrc")
                                                 ).max() > 0)}

        torch.cuda.reset_peak_memory_stats()
        iters, table, final, wall, launches, out = _drive_protocol(
            FRM_ARGS + OPTION_FLAGS + ["-model_fit", pdb], data, init,
            inspect=outputs)
        peak = torch.cuda.max_memory_allocated() / 2**30
        fit, fit_s = _sync_s(lambda: model_map_fit(
            model, final, pixel, low_res=50.0, high_res=7.0, device="cuda"))
    final_t = torch.as_tensor(final).cuda()
    bfac = guinier_bfactor(final_t, pixel,
                           max_res=max(iters[5]["fsc143_A"], 2.2 * pixel))
    # the likelihood-blurred insertion alone: 21 psi offsets over the
    # whole stack at full size, against the plain insertion
    poses = np.stack([data["phi"], data["theta"], data["psi"],
                      -data["shifts"][:, 0], -data["shifts"][:, 1]], 1)
    rec_kw = dict(batch=256, device="cuda")
    _, plain_s = _sync_s(lambda: rec.reconstruct(
        data["stack"], poses, data["ctf_params"], pixel, **rec_kw))
    _, lblur_s = _sync_s(lambda: rec.reconstruct(
        data["stack"], poses, data["ctf_params"], pixel, lblur_nrot=21,
        lblur_range=20.0, **rec_kw))
    cc_last = float(out["model_fit"][-1][1]) if out["model_fit"] else float("nan")
    row = {"phase": "frm_options", "seconds": wall,
           "shift_scored_match_launches": launches,
           **_quality(table, final, data, init),
           "final_fsc143_A": iters[max(iters)]["fsc143_A"],
           "guinier_bfactor_A2": bfac, "match_shape": out["match_shape"],
           "model_fit_lines": len(out["model_fit"]), "model_cc_last": cc_last,
           "model_map_fit_s": fit_s, "model_map_fit_cc": fit["cc"],
           "reconstruct_plain_s": plain_s, "reconstruct_lblur21_s": lblur_s,
           "max_memory_allocated_GiB": peak}
    emit(row)
    if sorted(iters) != [2, 3, 4, 5]:
        raise RuntimeError(f"expected iterations 2-5, ran {sorted(iters)}")
    if not (out["sharp_finite"] and out["sharp_differs"]
            and np.isfinite(bfac) and bfac < 0):
        raise RuntimeError(f"_sharp.mrc not written from a negative Guinier B "
                           f"(B {bfac}, {out})")
    if out["match_shape"] != [SLICE["n_particles"], box, box]:
        raise RuntimeError(f"_match.mrc holds {out['match_shape']}")
    if len(out["model_fit"]) != len(iters) or not cc_last >= MODEL_CC_BAR:
        raise RuntimeError(f"_model_fit.txt has {len(out['model_fit'])} lines "
                           f"for {len(iters)} iterations, last cc {cc_last}")
    if not row["cc_final_10A"] >= OPTIONS_CC_BAR:
        raise RuntimeError(f"cc vs truth {row['cc_final_10A']:.4f} is not "
                           f">= {OPTIONS_CC_BAR}")


LOCRES_MAX_A = 20.0


def phase_postprocess(final_halves):
    """The map modes on frm_slice's final half maps, each through
    cli.main(..., device="cuda") in one project: postprocess with local
    resolution, mask, then fsc with that mask. Bars: the corrected masked
    FSC(0.143) no coarser than the unmasked one plus one Fourier shell, a
    negative finite B, the median local resolution in [2 px, 20 Å], every
    output file present."""
    import contextlib
    import io

    import torch

    from pyp_tpu_torch import cli
    from pyp_tpu_torch.core import fsc as fsc_mod
    from pyp_tpu_torch.io import mrc
    from pyp_tpu_torch.postprocess import core as post
    from pyp_tpu_torch.postprocess import locres
    from pyp_tpu_torch.tools.e2e_spa import SLICE

    box, pixel = SLICE["box"], SLICE["pixel"]
    h1, h2 = (torch.as_tensor(h).cuda() for h in final_halves)
    f0, c0 = fsc_mod.fsc(h1, h2)
    unmasked_a = float(fsc_mod.resolution_at_threshold(f0, c0, pixel))
    cwd = os.getcwd()
    row = {"phase": "postprocess", "unmasked_fsc143_A": unmasked_a}

    def mode(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc, s = _sync_s(lambda: cli.main(argv, device="cuda"))
        if rc != 0:
            raise RuntimeError(f"cli.main({argv}) returned {rc}")
        return json.loads(buf.getvalue().strip().splitlines()[-1]), s

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as work:
        os.makedirs(os.path.join(work, "maps"))
        for h, name in zip(final_halves, ("half1", "half2")):
            mrc.write(h, os.path.join(work, "maps", f"dataset_r01_05_{name}.mrc"),
                      pixel_size=pixel)
        os.chdir(work)
        try:
            out, row["postprocess_s"] = mode(["postprocess", "-sharpen_locres"])
            mk, row["mask_s"] = mode(["mask", "-data_set", "dataset"])
            fs, row["fsc_s"] = mode(["fsc", "maps/dataset_r01_05_half1.mrc",
                                     "maps/dataset_r01_05_half2.mrc",
                                     "-fsc_mask", "dataset_mask.mrc"])
            files = ["maps/dataset_sharpened.mrc", "maps/dataset_fsc_masked.txt",
                     "maps/dataset_locres.mrc", "maps/dataset_locfilt.mrc",
                     "dataset_mask.mrc", "fsc.txt"]
            missing = [f for f in files if not os.path.exists(f)]
            mask = torch.as_tensor(mrc.read("dataset_mask.mrc")).cuda()
        finally:
            os.chdir(cwd)
    row["max_memory_allocated_GiB"] = torch.cuda.max_memory_allocated() / 2**30
    _, row["masked_fsc_s"] = _sync_s(lambda: post.masked_fsc(h1, h2, mask, pixel))
    _, row["local_resolution_s"] = _sync_s(lambda: locres.local_resolution(
        h1, h2, pixel, device="cuda"))
    row.update(masked_fsc143_A=out["resolution_A"], bfactor_A2=out["bfactor"],
               locres_median_A=out["locres_median_A"],
               mask_coverage=mk["coverage"],
               fsc_mode_masked_fsc143_A=fs["pairs"][0]["res_0.143_A"],
               missing_files=missing)
    emit(row)
    shell = 1.0 / (box * pixel)
    if not 1.0 / out["resolution_A"] >= 1.0 / unmasked_a - shell:
        raise RuntimeError(f"masked FSC(0.143) {out['resolution_A']:.3f} Å is "
                           f"coarser than the unmasked {unmasked_a:.3f} Å "
                           "plus one shell")
    if not (np.isfinite(out["bfactor"]) and out["bfactor"] < 0):
        raise RuntimeError(f"B-factor {out['bfactor']} is not negative")
    if not 2.0 * pixel <= out["locres_median_A"] <= LOCRES_MAX_A:
        raise RuntimeError(f"median local resolution {out['locres_median_A']} Å "
                           f"is outside [{2 * pixel}, {LOCRES_MAX_A}] Å")
    if missing:
        raise RuntimeError(f"missing outputs {missing}")


def main():
    import torch

    smi = phase_device()
    phase_build()
    k = phase_kernel()
    data, init = phase_synthesize()
    launches = phase_slice(data, init)
    phase_frm_polar(data)
    final_halves = phase_frm_slice(data, init)
    phase_frm_options(data, init)
    phase_postprocess(final_halves)
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "shift_scored_match", "route": "cuda",
        "source": "pyp_tpu_torch/csrc/shift_scored_match.cu",
        "replaces": "pyp_tpu/ops/pallas_kernels.py:80",
        "launches": launches, "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": "operations", "library_ms": k["library_ms"],
        "bound_fp32_ms": k["bound_fp32_ms"], "tflops": k["tflops"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
