"""Smoke run of pyp_tpu_torch on one CUDA card: builds the port's kernels
from the sources in this checkout, checks each against its plain PyTorch
version at the shapes the main paths give it, then drives the SPA
refinement loop through `pyp_tpu_torch.cli.main` on a synthetic
4,096-particle, box-128 dataset, once per engine, and the preprocessing
path (movies to a particle stack) on three synthetic 40 x 4096² movies,
and checks each result against the ground truth:

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
             B and a median local resolution inside [2 px, 20 Å];
  spr_synthesize  three K3-size movies (40 x 4096² at 1 Å/px, ~256
             particles each) with a planted drift, CTF and particle grid,
             written as MRC mode 0;
  spr        the `spr` mode on them, held to the planted truth: drift RMS
             error < 0.5 px, mean defocus within 1%, astigmatism angle
             within 10°, pick recall and precision >= 0.8, the three
             bundles and the merge summary written; a second call resumes
             and takes under a tenth of the first;
  spr_layers  each preprocessing layer's time on one of the movies, and
             micrographs per minute for alignment + CTF;
  extract    the `extract` mode: as many normalized particles as picks,
             the table's defocus equal to the fits, both files read back;
  spr_refine  the extracted stack through the FRM protocol (reported, no
             bar): movies to a map;

and, between postprocess and the preprocessing phases, ab initio and
classification (`tools/e2e_class`, on e2e_spa's truth):

  abinit     `refine -refine_abinit` without an initial model (ab initio on
             the FRM engine at the schema's defaults, then FRM_ARGS) on
             4,096 particles with +-1 px shifts: the ab initio map, aligned
             to the truth over rotation and hand, masked 10 Å cc >= 0.8;
             the final map FSC(0.143) <= 4.86 Å, aligned cc >= 0.94;
  abinit_classic  the classic engine (6 rounds; its global search runs
             shift_scored_match): particles score higher against its map
             than against a sphere;
  classify2d  `classify2d` on 4,096 particles of 8 views, polar, gather
             (the kernel) and staged: purity >= 0.8 (staged 0.75);
  classify3d  `classify3d` on two states of 2,048 particles at consensus
             poses, FRM, focused and gather: purity >= 0.8, class maps
             closer to their own state; then `kselection` and `clean`.

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
    # classic ab initio's last round: 2,048 particles x 24 psi, the
    # 300-12 Å band, the 15° lattice, +-6.4 px at 2 px
    ("abinit_classic", 2048 * 24, 178, 184, 31, 6),
    # the 2D gather E-step: 4,096 particles x 24 psi, the 100-10 Å band,
    # 8 classes, +-5 px at 2 px
    ("classify2d_gather", 4096 * 24, 252, 8, 16, 7),
]
# the main paths' shapes, timed beside the plain version, the library
# call and the bounds; the kernels line reports the gather slice's
TIMED_CASES = ("slice", "abinit_classic", "classify2d_gather")
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
        if name in TIMED_CASES:
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
            if name == "slice":
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


def _cli_json(argv, cwd):
    """cli.main(argv, device="cuda") run in `cwd` with stdout captured:
    (the JSON object it printed, wall seconds)."""
    import contextlib
    import io

    from pyp_tpu_torch import cli

    buf = io.StringIO()
    here = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(buf):
            rc, wall = _sync_s(lambda: cli.main(argv, device="cuda"))
    finally:
        os.chdir(here)
    if rc != 0:
        raise RuntimeError(f"cli.main({argv}) returned {rc}:\n{buf.getvalue()}")
    text = buf.getvalue()
    return json.loads(text[text.index("{"):]), wall


LOCRES_MAX_A = 20.0


def phase_postprocess(final_halves):
    """The map modes on frm_slice's final half maps, each through
    cli.main(..., device="cuda") in one project: postprocess with local
    resolution, mask, then fsc with that mask. Bars: the corrected masked
    FSC(0.143) no coarser than the unmasked one plus one Fourier shell, a
    negative finite B, the median local resolution in [2 px, 20 Å], every
    output file present."""
    import torch

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

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as work:
        os.makedirs(os.path.join(work, "maps"))
        for h, name in zip(final_halves, ("half1", "half2")):
            mrc.write(h, os.path.join(work, "maps", f"dataset_r01_05_{name}.mrc"),
                      pixel_size=pixel)
        os.chdir(work)
        try:
            out, row["postprocess_s"] = _cli_json(
                ["postprocess", "-sharpen_locres"], work)
            mk, row["mask_s"] = _cli_json(["mask", "-data_set", "dataset"], work)
            fs, row["fsc_s"] = _cli_json(
                ["fsc", "maps/dataset_r01_05_half1.mrc",
                 "maps/dataset_r01_05_half2.mrc", "-fsc_mask",
                 "dataset_mask.mrc"], work)
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


# ---- ab initio and classification ----------------------------------------
# the JAX package's bars: aligned masked cc of an ab initio map >= 0.8
# (tests/test_ab_initio.py:43); 2D purity >= 0.8, staged >= 0.75
# (tests/test_refine2d.py:71,126); 3D purity >= 0.8 and each class map
# closer to its own state (tests/test_classify3d.py:58-71)
ABINIT_CC_BAR, PURITY_BAR, STAGED_PURITY_BAR = 0.8, 0.8, 0.75
ABINIT_DATA = dict(n_particles=4096, box=128, noise_x=3.0, shift_max=1.0,
                   seed=0)
CLASSIC_ROUNDS, CLASSIC_STEP = 6, 15.0
CLASS2D_ARGS = ["classify2d", "-class_num", "8", "-class_rhcls", "10",
                "-scope_pixel", "1.0", "-no_plot_per_item"]
CLASS3D_ARGS = ["classify3d", "-class_num", "2", "-class3d_iters", "3",
                "-class_rhcls", "8", "-scope_pixel", "1.0",
                "-no_plot_per_item"]


def _timed_rows(stages, word):
    """(name, seconds) of the Timer lines whose name holds `word`."""
    return [[name, sec] for name, sec in stages.rows if word in name]


def phase_abinit(data):
    """`refine` with -refine_abinit and no initial_model.mrc through
    cli.main: ab initio at the schema's abinit_* defaults (the FRM engine),
    then the reference FRM protocol (e2e_spa.FRM_ARGS) from its map. Bars:
    initial_model.mrc aligned to the truth (rotation and hand) reaches a
    masked 10 Å cc >= 0.8; the final map FSC(0.143) <= 4.86 Å and aligned
    cc >= 0.94."""
    import torch

    from pyp_tpu_torch.io import mrc
    from pyp_tpu_torch.tools import e2e_class, e2e_spa, profile_refine
    from pyp_tpu_torch.tools.e2e_spa import FRM_ARGS

    box = ABINIT_DATA["box"]
    cwd = os.getcwd()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as work:
        e2e_spa.write_project(work, data, np.zeros((box,) * 3, np.float32))
        os.remove(os.path.join(work, "initial_model.mrc"))
        os.chdir(work)
        try:
            with _StageTimes() as stages:
                iters, wall = _sync_s(lambda: profile_refine.drive(
                    FRM_ARGS + ["-refine_abinit"], "cuda"))
            initial = mrc.read("initial_model.mrc")
            final = mrc.read(os.path.join("maps",
                                          f"dataset_r01_{max(iters):02d}.mrc"))
        finally:
            os.chdir(cwd)
    peak = torch.cuda.max_memory_allocated() / 2**30
    rounds = _timed_rows(stages, "ab-initio")
    (cc_init, _, ang_init, flip_init), init_align_s = _sync_s(
        lambda: e2e_class.aligned_cc(initial, data["volume"], device="cuda"))
    cc_final, _, _, flip_final = e2e_class.aligned_cc(final, data["volume"],
                                                      device="cuda")
    for it, row in iters.items():
        emit({"phase": "iteration", "argv": "abinit", "iteration": it, **row})
    row = {"phase": "abinit", "seconds": wall,
           "abinit_s": sum(sec for _, sec in rounds), "rounds": rounds,
           "refine_s": sum(r["wall_s"] for r in iters.values()),
           "cc_initial_aligned_10A": cc_init, "initial_angles": ang_init,
           "initial_flipped": flip_init, "align_volumes_s": init_align_s,
           "cc_final_aligned_10A": cc_final, "final_flipped": flip_final,
           "final_fsc143_A": iters[max(iters)]["fsc143_A"],
           "max_memory_allocated_GiB": peak}
    emit(row)
    if not (initial.shape == (box,) * 3 and np.isfinite(initial).all()):
        raise RuntimeError(f"initial_model.mrc has shape {initial.shape} or "
                           "non-finite values")
    if not cc_init >= ABINIT_CC_BAR:
        raise RuntimeError(f"ab initio map aligned cc {cc_init:.4f} is not "
                           f">= {ABINIT_CC_BAR}")
    if not row["final_fsc143_A"] <= FRM_FSC_BAR_A:
        raise RuntimeError(f"final FSC(0.143) {row['final_fsc143_A']:.2f} Å "
                           f"is not <= {FRM_FSC_BAR_A} Å")
    if not cc_final >= FRM_CC_BAR:
        raise RuntimeError(f"final map aligned cc {cc_final:.4f} is not >= "
                           f"{FRM_CC_BAR}")


def phase_abinit_classic(data):
    """ops.ab_initio.ab_initio (the classic subset engine, whose global
    search runs the shift_scored_match kernel) called directly for 6
    rounds at the CLI's 15° lattice. Bar (tests/test_ab_initio.py:78):
    the particles score higher against its map at its poses than against
    a featureless sphere. Reported: the aligned cc. Returns the kernel's
    launches in the run."""
    import torch

    from pyp_tpu_torch.core.filters import soft_spherical_mask
    from pyp_tpu_torch.ops import ab_initio, kernels
    from pyp_tpu_torch.tools import e2e_class

    box = ABINIT_DATA["box"]
    torch.cuda.reset_peak_memory_stats()
    kernels.shift_scored_match.launches = 0
    with _StageTimes() as stages:
        (vol, poses), wall = _sync_s(lambda: ab_initio.ab_initio(
            data["stack"], data["ctf_params"], 1.0, n_rounds=CLASSIC_ROUNDS,
            angular_step=CLASSIC_STEP, device="cuda"))
    launches = kernels.shift_scored_match.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    sphere = soft_spherical_mask(box, box * 0.3, 4.0).numpy()
    scores = {name: ab_initio.mean_particle_score(
        data["stack"], data["ctf_params"], poses, ref, 1.0, 12.0,
        device="cuda") for name, ref in (("model", vol), ("sphere", sphere))}
    cc_aligned, _, _, flipped = e2e_class.aligned_cc(vol, data["volume"],
                                                     device="cuda")
    row = {"phase": "abinit_classic", "seconds": wall,
           "rounds": _timed_rows(stages, "ab-initio"),
           "shift_scored_match_launches": launches,
           "score_model": scores["model"], "score_sphere": scores["sphere"],
           "cc_aligned_10A": cc_aligned, "flipped": flipped,
           "max_memory_allocated_GiB": peak}
    emit(row)
    if not np.isfinite(vol).all():
        raise RuntimeError("classic ab initio map has non-finite values")
    if launches < CLASSIC_ROUNDS:
        raise RuntimeError(f"classic ab initio launched shift_scored_match "
                           f"{launches} times in {CLASSIC_ROUNDS} rounds")
    if not scores["model"] > scores["sphere"]:
        raise RuntimeError(f"particles score {scores['model']:.4f} against "
                           f"the ab initio map, not above "
                           f"{scores['sphere']:.4f} against a sphere")
    return launches


def phase_classify2d():
    """`classify2d` through cli.main on 4,096 particles of 8 views (box
    128): the polar engine, the gather engine (the path of the
    shift_scored_match kernel) and the staged protocol. Bars: purity >=
    0.8 per engine, >= 0.75 staged; classes_2d.mrc of (8, 128, 128);
    best_2d_class written. Returns the gather run's kernel launches."""
    import torch

    from pyp_tpu_torch.io import cistem, mrc
    from pyp_tpu_torch.ops import kernels
    from pyp_tpu_torch.tools import e2e_class, e2e_spa

    data, synth_s = _sync_s(lambda: e2e_class.views_dataset(device="cuda"))
    box = data["stack"].shape[-1]
    runs = {"polar": [], "gather": ["-class_engine", "gather"],
            "staged": ["-class2d_staged", "-class2d_max_ab_initio", "1024"]}
    launches, failures = None, []
    for name, extra in runs.items():
        with tempfile.TemporaryDirectory() as work:
            e2e_spa.write_project(work, data, np.zeros((4,) * 3, np.float32))
            torch.cuda.reset_peak_memory_stats()
            kernels.shift_scored_match.launches = 0
            out, wall = _cli_json(CLASS2D_ARGS + extra, work)
            n_launch = kernels.shift_scored_match.launches
            avgs = mrc.read(os.path.join(work, "classes_2d.mrc"))
            table = cistem.read_parameters(os.path.join(work, "stack.cistem"))
        assign = np.asarray(table["best_2d_class"]) - 1 \
            if "best_2d_class" in table else np.zeros(len(data["labels"]))
        pur = e2e_class.purity(assign, data["labels"])
        emit({"phase": "classify2d", "run": name, "seconds": wall,
              "particles_per_s_iteration": len(assign) * 10 / wall,
              "purity": pur, "occupancy": out["occupancy"],
              "shift_scored_match_launches": n_launch,
              "classes_shape": list(avgs.shape), "synthesize_s": synth_s,
              "max_memory_allocated_GiB":
                  torch.cuda.max_memory_allocated() / 2**30})
        bar = STAGED_PURITY_BAR if name == "staged" else PURITY_BAR
        if not pur >= bar:
            failures.append(f"{name}: purity {pur:.3f} < {bar}")
        if avgs.shape != (8, box, box) or "best_2d_class" not in table:
            failures.append(f"{name}: classes_2d.mrc {avgs.shape} or no "
                            "best_2d_class")
        if name == "gather":
            launches = n_launch
            if n_launch < 1:
                failures.append("the gather engine never launched "
                                "shift_scored_match")
    if failures:
        raise RuntimeError("classify2d bars failed: " + "; ".join(failures))
    return launches


def phase_classify3d():
    """`classify3d` through cli.main on two states of 2,048 particles each
    at consensus poses (the truth, and the truth plus a 10 px blob at
    (20, 0, 0) px), from 0.5 (A + B): the FRM engine, the focused path
    (class_focusmask on the blob) and the gather engine (reported). Bars:
    purity >= 0.8 (FRM, focused); each class map closer to its own state;
    the maps and classes table written. Then `kselection` keeps B's class
    and `clean -clean_particles -clean_mode percentile
    -clean_check_reconstruction` writes a finite maps/clean_check.mrc."""
    import torch

    from pyp_tpu_torch.io import cistem, mrc
    from pyp_tpu_torch.tools import e2e_class

    data, synth_s = _sync_s(lambda: e2e_class.two_state_dataset(
        device="cuda"))
    vol_a, vol_b = data["volumes"]
    start = 0.5 * (vol_a + vol_b)
    runs = {"frm": [], "focused": ["-class_focusmask", "20,0,0,14"],
            "gather": ["-refine_engine", "gather"]}
    failures = []
    for name, extra in runs.items():
        with tempfile.TemporaryDirectory() as work:
            e2e_class.write_posed_project(work, data, start)
            torch.cuda.reset_peak_memory_stats()
            with _StageTimes() as stages:
                out, wall = _cli_json(CLASS3D_ARGS + extra, work)
            peak = torch.cuda.max_memory_allocated() / 2**30
            maps = os.path.join(work, "maps")
            last = out["iterations"][-1]["iteration"]
            refs = [mrc.read(os.path.join(maps, f"dataset_r0{k}_{last:02d}.mrc"))
                    for k in (1, 2)]
            table = cistem.read_parameters(os.path.join(work, "stack.cistem"))
            written = os.path.exists(os.path.join(
                maps, f"dataset_classes_{last:02d}.cistem"))
            assign = np.asarray(table["best_2d_class"]) - 1
            ccs = np.array([[e2e_class.cc(r, v) for v in (vol_a, vol_b)]
                            for r in refs])
            # the class most of state A's particles went to is A's class
            k_a = int(np.bincount(assign[data["labels"] == 0],
                                  minlength=2).argmax())
            b_class = 2 - k_a                      # 1-based, the other one
            row = {"phase": "classify3d", "run": name, "seconds": wall,
                   "iterations": _timed_rows(stages, "classification"),
                   "purity": e2e_class.purity(assign, data["labels"]),
                   "class_vs_state_cc": ccs.tolist(),
                   "occupancy": out["iterations"][-1]["occupancy"],
                   "max_memory_allocated_GiB": peak, "synthesize_s": synth_s}
            if name == "frm":
                ks, row["kselection_s"] = _cli_json(
                    ["kselection", "-keep_classes", str(b_class)], work)
                row["kselection_kept"] = ks["kept"]
                cl, row["clean_s"] = _cli_json(
                    ["clean", "-clean_particles", "-clean_mode", "percentile",
                     "-clean_check_reconstruction"], work)
                row["clean_kept"] = cl["kept"]
                check = mrc.read(os.path.join(maps, "clean_check.mrc"))
                row["clean_check_finite"] = bool(np.isfinite(check).all())
                if ks["kept"] != int((assign == b_class - 1).sum()):
                    failures.append(f"kselection kept {ks['kept']}, not the "
                                    f"class's {(assign == b_class - 1).sum()}")
                if not row["clean_check_finite"]:
                    failures.append("maps/clean_check.mrc is not finite")
        emit(row)
        matched = ccs[k_a, 0] + ccs[1 - k_a, 1]
        crossed = ccs[k_a, 1] + ccs[1 - k_a, 0]
        if name != "gather":
            if not row["purity"] >= PURITY_BAR:
                failures.append(f"{name}: purity {row['purity']:.3f} < "
                                f"{PURITY_BAR}")
            if not matched > crossed:
                failures.append(f"{name}: class maps no closer to their own "
                                f"state: {ccs.tolist()}")
            if not written:
                failures.append(f"{name}: no maps/dataset_classes_{last:02d}"
                                ".cistem")
    if failures:
        raise RuntimeError("classify3d bars failed: " + "; ".join(failures))


# ---- preprocessing: movies to a particle stack -----------------------------
DRIFT_RMS_BAR_PX, DEFOCUS_BAR_REL, ANGAST_BAR_DEG = 0.5, 0.01, 10.0
PICK_RECALL_BAR, PICK_PRECISION_BAR, RESUME_BAR = 0.8, 0.8, 0.1
BG_MEAN_BAR, BG_VAR_BAR = 0.05, 0.05


class _StageTimes:
    """A logging handler that collects the `Timer` lines of the
    preprocessing stages (name, seconds) and, at the end of each
    micrograph's last stage, the device memory peak since the one
    before."""

    def __init__(self):
        import logging

        outer = self

        class Handler(logging.Handler):
            def emit(self, record):
                outer.on_message(record.getMessage())

        self.rows, self.peaks = [], []
        self.handler = Handler()
        self.logger = logging.getLogger("pyp_tpu_torch.timer")

    def on_message(self, msg):
        import torch

        name, sep, tail = msg.rpartition(" took ")
        if not sep:
            return
        self.rows.append((name, float(tail.rstrip("s"))))
        if name == "particle picking":
            self.peaks.append(torch.cuda.max_memory_allocated() / 2**30)
            torch.cuda.reset_peak_memory_stats()

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        return False


def phase_spr_synthesize(volume, movies_dir):
    from pyp_tpu_torch.tools import e2e_spr

    kw = {k: v for k, v in e2e_spr.MOVIES.items() if k != "n_movies"}
    (truth, nbytes), seconds = _sync_s(lambda: e2e_spr.write_movies(
        movies_dir, volume, n_movies=e2e_spr.MOVIES["n_movies"],
        device="cuda", **kw))
    emit({"phase": "spr_synthesize", "seconds": seconds, "bytes": nbytes,
          "movies": len(truth), "frames": kw["n_frames"], "size": kw["size"],
          "particles_planted": sum(len(t["centres"]) for t in truth.values())})
    return truth


def phase_spr(movies_dir, project, truth):
    """The `spr` mode on the movie set, held to the planted truth, then
    the same call again, which must only resume."""
    import torch

    from pyp_tpu_torch.io.metadata import ItemMetadata
    from pyp_tpu_torch.tools import e2e_spr

    argv = e2e_spr.SPR_ARGS + ["-data_path",
                               os.path.join(movies_dir, "movie_*.mrc")]
    os.makedirs(project)
    torch.cuda.reset_peak_memory_stats()
    with _StageTimes() as stages:
        merge, wall = _cli_json(argv, project)
    per_stage = {}
    for name, sec in stages.rows:
        per_stage.setdefault(name, []).append(sec)
    failures = []
    for i, (name, t) in enumerate(sorted(truth.items())):
        meta = ItemMetadata(name, project).load()
        missing = [k for k in ("drift", "average", "ctf", "box")
                   if not meta.is_done(k)]
        if missing:
            raise RuntimeError(f"{name}: bundle lacks {missing}")
        c = meta["ctf"]
        recall, precision = e2e_spr.pick_recall_precision(
            meta["box"][:, :2], t["centres"], e2e_spr.PARTICLE_RADIUS_A / 2)
        row = {
            "phase": "spr", "micrograph": name,
            "align_s": per_stage["movie alignment"][i],
            "ctf_s": per_stage["CTF estimation"][i],
            "pick_s": per_stage["particle picking"][i],
            "max_memory_allocated_GiB": stages.peaks[i],
            "drift_rms_err_px": e2e_spr.drift_rms_error(meta["drift"],
                                                        t["trajectory"]),
            "defocus_fit_A": [float(c[0]), float(c[1])],
            "defocus_planted_A": [t["df1"], t["df2"]],
            "defocus_mean_rel_err": abs(
                (c[0] + c[1]) / (t["df1"] + t["df2"]) - 1.0),
            "angast_fit_deg": float(c[2]), "angast_planted_deg": t["angast"],
            "angast_err_deg": e2e_spr.angle_error_deg(float(c[2]), t["angast"]),
            "fit_res_A": float(c[5]), "picks": int(len(meta["box"])),
            "planted": len(t["centres"]), "recall": recall,
            "precision": precision}
        emit(row)
        for key, ok in (("drift_rms_err_px", row["drift_rms_err_px"] < DRIFT_RMS_BAR_PX),
                        ("defocus_mean_rel_err", row["defocus_mean_rel_err"] < DEFOCUS_BAR_REL),
                        ("angast_err_deg", row["angast_err_deg"] < ANGAST_BAR_DEG),
                        ("recall", recall >= PICK_RECALL_BAR),
                        ("precision", precision >= PICK_PRECISION_BAR)):
            if not ok:
                failures.append(f"{name}: {key} = {row[key]}")
    with _StageTimes() as again:
        merge2, wall2 = _cli_json(argv, project)
    emit({"phase": "spr", "seconds": wall, "micrographs": merge["micrographs"],
          "particles": merge["particles"], "missing": merge["missing"],
          "mean_ctf_fit_res_A": merge["mean_ctf_fit_res"],
          "micrographs_per_min": 60.0 * merge["micrographs"] / wall,
          "resume_seconds": wall2, "resume_stages_run": len(again.rows),
          "resume_particles": merge2["particles"]})
    if merge["micrographs"] != len(truth) or merge["missing"]:
        failures.append(f"merge summary {merge}")
    if again.rows or merge2 != merge:
        failures.append(f"the second call ran stages {again.rows} or merged "
                        f"{merge2}")
    if not wall2 < RESUME_BAR * wall:
        failures.append(f"the resumed call took {wall2:.2f} s, not under "
                        f"{RESUME_BAR} of {wall:.2f} s")
    if failures:
        raise RuntimeError("spr bars failed: " + "; ".join(failures))


def phase_spr_layers(movies_dir):
    """Device-synchronised medians of each preprocessing layer on one
    movie at full size, the zoom DFT beside a plain irfft2 of the same
    cross spectra, micrographs per minute for alignment + CTF, and one
    direct `process_micrograph` call that must upload the movie once."""
    import torch

    from pyp_tpu_torch.config import schema
    from pyp_tpu_torch.io.metadata import ItemMetadata
    from pyp_tpu_torch.ops import ctf_fit, motion, pick
    from pyp_tpu_torch.pipeline import spr

    path = os.path.join(movies_dir, "movie_00.mrc")
    (raw, load_s) = _sync_s(lambda: spr.load_movie(path, dtype=None))
    frames, upload_s = _sync_s(lambda: spr._upload(raw, "cuda"))
    n, ny, nx = frames.shape
    row = {"phase": "spr_layers", "frames": [n, ny, nx],
           "load_movie_s": load_s, "upload_s": upload_s,
           "remove_hot_pixels_ms": _median_ms(
               lambda: pick.remove_hot_pixels(frames), reps=3)}
    one = frames[0].reshape(-1)
    half = one.numel() // 2
    row["median_sort_ms"] = _median_ms(lambda: pick.median(one), reps=5)
    row["median_kthvalue_ms"] = _median_ms(
        lambda: 0.5 * (torch.kthvalue(one, half).values
                       + torch.kthvalue(one, half + 1).values), reps=3)
    binning, iters = 2, 8
    row["stack_rfft2_ms"] = _median_ms(lambda: motion._spectra(frames, binning),
                                       reps=3)
    F_full, F_small = motion._spectra(frames, binning)
    nys, nxs = ny // binning, nx // binning
    Fw = F_small * motion._weight_filter(nys, nxs, 1.0 * binning, 1500.0, 0.0,
                                         0.0, frames.device)
    del F_small
    found = {}
    for label, zoom in (("zoom_dft", True), ("irfft2", False)):
        found[label] = motion._align_spectra(
            Fw, nys, nxs, max_iters=iters, search_radius=48.0 / binning,
            zoom=zoom)[0]
        row[f"align_iteration_{label}_ms"] = _median_ms(
            lambda: motion._align_spectra(
                Fw, nys, nxs, max_iters=iters, search_radius=48.0 / binning,
                zoom=zoom), reps=5) / iters
    row["zoom_vs_irfft2_max_shift_diff_px"] = float(
        (found["zoom_dft"] - found["irfft2"]).abs().max())
    del Fw
    shifts = found["zoom_dft"] * binning
    doses = torch.arange(1, n + 1, dtype=torch.float32, device="cuda")
    row["average_spectra_ms"] = _median_ms(
        lambda: motion._average_spectra_scan(F_full, shifts, doses, ny, nx),
        reps=3)
    avg = motion._average_spectra_scan(F_full, shifts, doses, ny, nx)
    del F_full
    row["periodogram_ms"] = _median_ms(lambda: ctf_fit.periodogram(avg, 512),
                                       reps=5)
    power = ctf_fit.periodogram(avg, 512)
    row["fit_ctf_ms"] = _median_ms(
        lambda: ctf_fit.fit_ctf(power, 1.0, device="cuda"), reps=3)
    row["pick_particles_ms"] = _median_ms(
        lambda: pick.pick_particles(avg, particle_radius_px=45, max_picks=1024,
                                    edge_px=64, device="cuda"), reps=3)

    # what the JAX package's bench times on its preprocess axis: alignment
    # of a device-resident movie, then the CTF fit of its average
    def align():
        return motion.align_movie_large(frames, pixel_size=1.0, binning=2,
                                        device="cuda").average

    torch.cuda.reset_peak_memory_stats()
    row["align_movie_large_ms"] = _median_ms(align, reps=3)
    row["align_max_memory_allocated_GiB"] = torch.cuda.max_memory_allocated() / 2**30
    row["fit_ctf_micrograph_ms"] = _median_ms(
        lambda: ctf_fit.fit_ctf_micrograph(avg, 1.0, device="cuda"), reps=3)
    row["micrographs_per_min_align_ctf"] = 60e3 / (
        row["align_movie_large_ms"] + row["fit_ctf_micrograph_ms"])
    del frames, avg, power
    torch.cuda.empty_cache()

    params = schema.defaults()
    params.update(scope_pixel=1.0, detect_rad=45.0, detect_thresh=3.0,
                  extract_box=128, plot_per_item=False)
    with tempfile.TemporaryDirectory() as work:
        summary, row["process_micrograph_s"] = _sync_s(
            lambda: spr.process_micrograph({"name": "one", "frames": raw},
                                           params, work, device="cuda"))
        # the host's share: reading and writing the compressed bundle
        meta = ItemMetadata("one", work).load()
        _, row["bundle_read_average_s"] = _sync_s(lambda: meta["average"])
        _, row["bundle_save_s"] = _sync_s(meta.save)
    row["frame_uploads"] = summary["frame_uploads"]
    emit(row)
    if summary["frame_uploads"] != 1:
        raise RuntimeError(f"process_micrograph uploaded the movie "
                           f"{summary['frame_uploads']} times")
    if not row["zoom_vs_irfft2_max_shift_diff_px"] < 0.05:
        raise RuntimeError("the zoom DFT and the plain irfft2 disagree on the "
                           f"shifts by {row['zoom_vs_irfft2_max_shift_diff_px']} px")


def phase_extract(project, truth):
    """The `extract` mode on the project `spr` filled: stack.mrc +
    stack.cistem, read back and held to the picks and the fits."""
    from pyp_tpu_torch.io import cistem, mrc
    from pyp_tpu_torch.io.metadata import ItemMetadata

    out, wall = _cli_json(["extract"], project)
    stack = mrc.read(os.path.join(project, "stack.mrc"))
    table = cistem.read_parameters(os.path.join(project, "stack.cistem"))
    metas = [ItemMetadata(name, project).load() for name in sorted(truth)]
    picks = sum(len(m["box"]) for m in metas)
    box = stack.shape[-1]
    ax = np.arange(box) - box // 2
    bg = np.sqrt(ax[:, None] ** 2 + ax[None, :] ** 2) >= 0.375 * box + 2.0
    bg_mean = stack[:, bg].mean(axis=1)
    bg_var = stack[:, bg].var(axis=1)
    fits = np.concatenate([np.repeat(m["ctf"][None, :3], len(m["box"]), 0)
                           for m in metas])
    got = np.stack([table["defocus_1"], table["defocus_2"],
                    table["defocus_angle"]], 1)
    row = {"phase": "extract", "seconds": wall, "particles": int(len(stack)),
           "picks": int(picks), "particles_per_s": len(stack) / wall,
           "box": int(box), "finite": bool(np.isfinite(stack).all()),
           "bg_mean_max_abs": float(np.abs(bg_mean).max()),
           "bg_var_max_rel_err": float(np.abs(bg_var - 1.0).max()),
           "defocus_columns_max_abs_diff": float(np.abs(got - fits).max())}
    emit(row)
    if not (out["particles"] == len(stack) == len(table["defocus_1"]) == picks
            and stack.shape[1:] == (128, 128) and row["finite"]):
        raise RuntimeError(f"extract wrote {stack.shape} for {picks} picks")
    if not (row["bg_mean_max_abs"] < BG_MEAN_BAR
            and row["bg_var_max_rel_err"] < BG_VAR_BAR):
        raise RuntimeError(f"particle backgrounds are not normalized: {row}")
    if not row["defocus_columns_max_abs_diff"] < 0.01:
        raise RuntimeError("the table's defocus columns differ from the fits")


def phase_spr_refine(project, volume):
    """The extracted stack and table with a 20 Å low-pass of the truth as
    the starting map through the FRM protocol: movies to a map. Run twice:
    on the stack as `extract` writes it (contrast inverted, the mode's
    default) and on its negative, the micrograph's own contrast, which is
    what the refinement's CTF model (-sin chi) describes. Reported, not
    held to a bar (a few hundred particles)."""
    import shutil

    from pyp_tpu_torch.io import mrc
    from pyp_tpu_torch.tools import e2e_spa, e2e_spr, profile_refine
    from pyp_tpu_torch.tools.e2e_spa import FRM_ARGS, SLICE

    truth = e2e_spr.with_envelope(volume, e2e_spr.MOVIES["envelope"])
    init = e2e_spa.starting_map(truth, SLICE["pixel"], e2e_spa.START_RESOLUTION)
    stack = mrc.read(os.path.join(project, "stack.mrc"))
    cwd = os.getcwd()
    for contrast, sign in (("as_extracted", 1.0), ("micrograph", -1.0)):
        with tempfile.TemporaryDirectory() as work:
            shutil.copy(os.path.join(project, "stack.cistem"), work)
            mrc.write(sign * stack, os.path.join(work, "stack.mrc"),
                      pixel_size=SLICE["pixel"])
            mrc.write(init, os.path.join(work, "initial_model.mrc"),
                      pixel_size=SLICE["pixel"])
            os.chdir(work)
            try:
                iters, wall = _sync_s(
                    lambda: profile_refine.drive(FRM_ARGS, "cuda"))
            finally:
                os.chdir(cwd)
            last = max(iters)
            final = mrc.read(os.path.join(work, "maps",
                                          f"dataset_r01_{last:02d}.mrc"))
        emit({"phase": "spr_refine", "contrast": contrast, "seconds": wall,
              "particles": int(len(stack)), "iterations": sorted(iters),
              "final_fsc143_A": iters[last]["fsc143_A"],
              "cc_start_10A": e2e_spa.masked_cc(init, truth, SLICE["pixel"], 10.0),
              "cc_final_10A": e2e_spa.masked_cc(final, truth, SLICE["pixel"], 10.0)})
        if final.shape != (SLICE["box"],) * 3 or not np.isfinite(final).all():
            raise RuntimeError(f"spr_refine's final map has shape "
                               f"{final.shape} or non-finite values")


def phase_preprocess(volume):
    """The preprocessing phases on one movie set in a temporary directory."""
    with tempfile.TemporaryDirectory() as root:
        movies_dir = os.path.join(root, "movies")
        project = os.path.join(root, "project")
        truth = phase_spr_synthesize(volume, movies_dir)
        phase_spr(movies_dir, project, truth)
        phase_spr_layers(movies_dir)
        phase_extract(project, truth)
        phase_spr_refine(project, volume)


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
    volume = data["volume"]
    del data, init, final_halves
    from pyp_tpu_torch.tools import e2e_spa

    abinit_data = e2e_spa.make_dataset(device="cuda", **ABINIT_DATA)
    phase_abinit(abinit_data)
    classic = phase_abinit_classic(abinit_data)
    del abinit_data
    gather2d = phase_classify2d()
    phase_classify3d()
    phase_preprocess(volume)
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "shift_scored_match", "route": "cuda",
        "source": "pyp_tpu_torch/csrc/shift_scored_match.cu",
        "replaces": "pyp_tpu/ops/pallas_kernels.py:80",
        "launches": {"slice": launches, "abinit_classic": classic,
                     "classify2d_gather": gather2d},
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": "operations", "library_ms": k["library_ms"],
        "bound_fp32_ms": k["bound_fp32_ms"], "tflops": k["tflops"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
