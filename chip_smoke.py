"""Smoke run of pyp_tpu_torch on one CUDA card: builds the port's kernel
and its host library from the sources in this checkout, checks each against its plain PyTorch
version at the shapes the main paths give it, then drives the SPA
refinement loop through `pyp_tpu_torch.cli.main` on a synthetic
4,096-particle, box-128 dataset, once per engine, the preprocessing
path (movies to a particle stack) on three synthetic 40 x 4096² movies,
the tomography path on a synthetic 41-tilt series, and the subtomogram
path (CSP, SVA) and particle polishing on top of those, and checks each
result against the ground truth:

  slice      the gather engine (the path of the shift_scored_match kernel);
  distributed  the multi-GPU path on the one card: (i) a world-size-1 NCCL
             group in a subprocess (`--distributed-one`, joined through
             the PYP_TPU_* environment) runs sharded_refine_batch on the
             slice's global-search batch, reconstruct_sharded of its
             4,096 particles, and sharded_accumulate_matrices and
             csp_refine_batch_sharded at csp_layers' shape, each equal to
             its single-device function to 1e-6 x max; (ii) the
             distributed script of `refine -slurm_queue q -slurm_nodes 2`
             (REFINE_ARGS' first two iterations) run by bash with srun and
             scontrol shims, two gloo ranks sharing the card: rank 0 alone
             writes maps/, poses within the gather parity tolerances of
             the slice run, FSC(0.143) within a shell, every rank launches
             the kernel;
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
  slurm      `spr -slurm_queue q -slurm_bundle 2` on links to the movies:
             bash runs both array elements of the emitted swarm at once
             (a `worker` per movie), then the merge's: picks and defocus
             equal to the spr phase's; the launcher built from
             csrc/launcher.cpp maps its `spr` alias to
             `python -m pyp_tpu_torch.cli spr`;
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

and, after the preprocessing phases, tomography (`tools/e2e_tomo`: 41
tilts of 4096² at 1 Å/px, -60° to 60° in 3° steps, a 3° tilt axis,
shifts of +-40 px, defocus 3-4 µm, particles, virions, gold beads, a
filament and a membrane sheet with known geometry):

  tomo_synthesize  the series as ts01.mrc (MRC mode 1) + ts01.tlt;
  tomo       `cli.main(["tomo", ...])` at the schema's defaults plus
             -tomo_spk_method auto: axis angle within 0.5°, median
             per-tilt shift error < 1 binned px, mean defocus within 2%,
             tomogram cc with the truth > 0.6 in the central slab, pick
             recall >= 0.8 within one particle radius, a resumed call
             under a tenth of the first;
  tomo_options  (a) fiducial alignment with bead erasure, dose
             weighting, CTF correction, handedness and halves (>= 4
             beads, the alignment bars, the planted hand, both halves);
             from copies of `tomo`'s bundle (b) SART (cc > 0.6), (c)
             surface picking (the refined surfaces' centres within 2
             voxels of the virions', radii within 10%), (d) template matching with the planted
             particle's map (recall >= 0.8), (e) filament picking (picks
             with a tangent prior each, inside the volume; their median
             distance to the planted axis read, not barred), (f) membrane
             segmentation (>= 50% of the sheet's voxels in the mask), (g)
             bm4d, nad and deconv (finite volumes);
  tomo_mdoc  the .mdoc path: 41 four-frame 4096² tilt movies assembled,
             then the alignment and CTF bars;
  tomo_layers  each layer's time at full size, WBP also at 41 x 1024² ->
             256 x 1024² (voxels/s beside its bound);
  tomo_thick  `tomo` on the same field with its content spread through
             the thickness: mean defocus within 2%; the alignment,
             tomogram cc and recall read without bars (the known limit
             of patch tracking);

and the subtomogram phases:

  csp_layers  the CSP refinement alone at the reference bench's shape (8
             series x 41 tilts x 128 particles, box 64 at 2 Å/px, the
             60-8 Å band, modes 3:0:2:1 x 20 steps) on windows of noise,
             plain and with the grid search, series sequential and
             vectorized: the first call's s (it captures the mode
             graphs), projections/s of the next, peak memory, a step's
             split, and
             accumulate_matrices of the 41,984 rows (no quality bar);
  csp_gather  the CSP model gather's kernel (csp_slice_gather) at that
             shape against its plain version: forward max abs error <=
             1e-5 x max|u| with the same zeros, backward relative L2 <=
             1e-4 for mode 0's and mode 1's blocks; kernel, plain and
             bound times; 47 forward and 40 backward launches a unit;
  csp_graph  the CSP step loops as CUDA graphs (ops.csp.ModeGraphs) at
             that shape, each mode of 3:0:2:1: capture and replays, one
             with other inputs, equal bit for bit to the eager step
             function, and csp_refine_batch with the graphs equal to the
             same schedule with eager steps; eager, first-call and replay
             ms, a replay's gather launches, counted and as the profiler
             sees them run;
  csp_tomo  `tools/e2e_tomo.CSP_SERIES` (the tomo field with a particle
             whose projections change with its orientation) through `tomo`,
             picked by template matching with the particle map;
  csp        `csp` on copies of that project, started from `tools/e2e_csp`
             (the port's picks matched to the planted particles, their
             rotations turned by 8°, the negated particle map at box 256):
             the reference's sign above the other; the default schedule
             with the median orientation error below the start's, the
             per-tilt shift error no worse than the bundle's, the
             average's cc with the reference > 0.5 and a resumed call
             under a tenth; `-csp_GridSearch` from 16° below 16°; three
             renamed copies refined together, each within 1e-2 (°, px) of
             the single run;
  sva        `sva` on the csp_tomo project's tomogram and its 3D picks,
             one per planted particle (reference-free, -sva_ref,
             -sva_classes 2): each average's cc with the particle map
             after align_volumes > 0.5;
  polish     (after spr_refine) `polish` on the three movies at the FRM
             run's poses and map, then the FRM protocol on the polished
             stack: FSC(0.143) within a shell of the unpolished run's.

and, after spr_refine, the streaming slice's host layers around the
card paths (each phase reads shift_scored_match's launches, 0):

  interop    `export_star` of spr_refine's micrograph-contrast run, then
             `import_star` into a fresh project: eulers within 1e-3°,
             shifts within 1e-3 px, defocus within 0.1 Å; `refine` (FRM,
             two iterations at the run's last two limits) from the
             imported poses and its final map, FSC(0.143) no worse than a
             shell above spr_refine's; `byp` .cistem -> .par read back
             equal to the .par's printed precision;
  stream     `cli.main(["stream", ...])` in a thread while the three
             movies appear one by one in a watch directory (spr's flags,
             8 classes, a file metadb): each movie's picks and defocus
             equal to the spr phase's bundles, classes whose occupancies
             sum to the particles, 3 micrographs and the classes in the
             metadb; a pypd.restart changing a ctf_ parameter re-runs CTF
             estimation alone; pypd.stop ends it; `export_session` writes
             a 3-row micrographs star and every pick; seconds per movie
             beside spr's;
  workflow   `workflows/spa_tutorial.toml` through `cli.main(["workflow",
             ...])` on the three movies (spr + extract, refine, postprocess)
             with spr's flags, -no_extract_inv, the 20 Å start and the FRM
             protocol: every block rc 0, FSC(0.143) no worse than a shell
             above spr_refine's micrograph-contrast run; the wall per block;

and, right after the kernel check, `tiff_lzw`: a 4 x 1024² int8 LZW TIFF
movie read by `io/tiff` through the native pypio library (built from
`pyp_tpu_torch/csrc/pypio.cpp` beside the kernel) and, on one strip,
through the Python decoder: MB/s of each, arrays equal.

and the learned models (pyp_tpu_torch/models, torch.nn; each phase
reads shift_scored_match's launches, 0):

  heterogeneity  (after classify3d) `heterogeneity` at the schema's
             defaults on classify3d's two states x 2,048 at consensus
             poses: PC1 purity >= 0.8, each PC1 end closer to its own
             state; (after sva) the tilt branch (100 training steps) on
             `csp -csp_save_stacks`
             of the csp start: latents and volumes written, read;
  models_spr  (after extract) `sprtrain` on two of the spr bundles, `spr
             -detect_method nn` on the third (recall read beside the JAX
             package's 0.7), `spr -denoise_spr n2n` on a fresh project
             (the spr recall and precision bars) then `-prism_enable`
             (scores written), `prism` with a blank micrograph (scored
             below the median);
  models_tomo  (after tomo_options) from copies of tomo's bundle: n2n
             (finite; slab cc read beside the raw one's), wedge (the
             measured sector unchanged within 1e-2), `-tomo_vir_method nn`
             (the surface bars of (c)), `tomotrain`, `mine` (every grid
             patch in one cluster).

    python3 chip_smoke.py

Prints one JSON line per phase, the card's name and power limit, a
`{"kernels": [...]}` line, and as its last line
`{"ok": true, "device": {...}}`. Any failed phase exits non-zero without
that last line; so does a machine with no CUDA device.
`python3 chip_smoke.py --distributed-one <project>` is (i) of the
distributed phase, which starts it.
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
    """The libraries from the checkout's sources, started together: the
    CUDA kernels (nvcc) and the host library pypio (g++), which the TIFF
    reader hands its LZW strips."""
    from concurrent.futures import ThreadPoolExecutor

    from pyp_tpu_torch.ops import _build

    def build(name):
        t0 = time.perf_counter()
        path = _build.build(name)
        _build.load(name)
        return name, os.path.relpath(path, ROOT), time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        built = list(pool.map(build, ("shift_scored_match", "pypio",
                                      "csp_slice_gather", "csp_score",
                                      "insert_scatter")))
    emit({"phase": "build", "kernel": "shift_scored_match",
          "library": built[0][1], "kernel_seconds": built[0][2],
          "host_library": built[1][1], "host_library_seconds": built[1][2],
          "gather_library": built[2][1], "gather_seconds": built[2][2],
          "score_library": built[3][1], "score_seconds": built[3][2],
          "insert_library": built[4][1], "insert_seconds": built[4][2],
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
    kernel. Returns its launches and, for the distributed phase, its
    tables and FSC(0.143) at iterations 2 and 3."""
    from pyp_tpu_torch.tools.e2e_spa import REFINE_ARGS, SLICE

    iters, table, final, wall, launches, tables = _drive_protocol(
        REFINE_ARGS, data, init, inspect=_slice_tables)
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
    return launches, {"tables": tables,
                      "fsc143_A": {it: iters[it]["fsc143_A"]
                                   for it in tables}}


DIST_MAXITER = "2"             # the 2-rank run: iterations 2 (global) and 3
DIST_REL_TOL = 1e-6            # one NCCL rank against one device, x max
DIST_BATCH = 256               # the gather slice's global-search batch
DIST_CSP_ITERS = 5             # steps a mode: csp_layers' shape, fewer steps


def _slice_tables(maps_dir, stem):
    """The slice run's tables at iterations 2 and 3 (the 2-rank run's)."""
    from pyp_tpu_torch.io import cistem

    return {it: cistem.read_parameters(
        os.path.join(maps_dir, f"dataset_r01_{it:02d}.cistem"))
        for it in (2, 3)}


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start_group(cmd, **kw):
    """`cmd` started in a session of its own, its output spooled to files
    (see _finish_group)."""
    logs = [tempfile.TemporaryFile("w+") for _ in range(2)]
    proc = subprocess.Popen(cmd, stdout=logs[0], stderr=logs[1], text=True,
                            start_new_session=True, **kw)
    proc.logs = logs
    return proc


def _finish_group(proc, timeout):
    """(returncode, stdout, stderr) of a `_start_group` process; every
    process of its session is killed if it outlasts `timeout`."""
    import signal

    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        rc = 124
    texts = []
    for f in proc.logs:
        f.seek(0)
        texts.append(f.read())
        f.close()
    return (rc, *texts)


def _run_group(cmd, timeout, **kw):
    return _finish_group(_start_group(cmd, **kw), timeout)


def _rot_diff_deg(a, b):
    """Rotation angle between the (phi, theta, psi) columns of two
    tables."""
    import torch

    from pyp_tpu_torch.core.geometry import euler_to_matrix

    def R(t):
        return euler_to_matrix(*(torch.as_tensor(np.asarray(t[k], np.float32))
                                 for k in ("phi", "theta", "psi")))

    tr = torch.einsum("bij,bij->b", R(a), R(b)).numpy()
    return np.degrees(np.arccos(np.clip((tr - 1) / 2, -1, 1)))


def distributed_one(work):
    """(i) of the distributed phase, in its own process: a world-size-1
    NCCL group (joined through PYP_TPU_COORDINATOR / NUM_PROCS / PROC_ID)
    runs sharded_refine_batch on the gather slice's global-search batch
    (its first 256 particles; the path of shift_scored_match),
    reconstruct_sharded of the 4,096 particles at the slice's refined
    poses, and sharded_accumulate_matrices and csp_refine_batch_sharded at
    csp_layers' shape (the schedule DIST_CSP_ITERS steps a mode), each
    beside the single-device function on the same inputs. Deterministic algorithms, so that a one-rank all_reduce, the
    identity, leaves the results equal. Prints one JSON row."""
    import torch
    import torch.distributed as dist

    from pyp_tpu_torch import cli, parallel
    from pyp_tpu_torch.io import cistem, mrc
    from pyp_tpu_torch.ops import csp, kernels, refine3d
    from pyp_tpu_torch.ops import reconstruct as rec
    from pyp_tpu_torch.pipeline.refine import (gather_search_kwargs,
                                               table_to_ctf_params,
                                               table_to_poses)
    from pyp_tpu_torch.tools.e2e_spa import REFINE_ARGS, SLICE

    torch.use_deterministic_algorithms(True, warn_only=True)
    if not parallel.init_distributed():
        raise RuntimeError("PYP_TPU_COORDINATOR is not set")
    row = {"phase": "distributed_one", "backend": dist.get_backend(),
           "world_size": dist.get_world_size(), "steps": {}}
    mesh = parallel.make_mesh()
    pixel = SLICE["pixel"]
    stack = mrc.read(os.path.join(work, "stack.mrc")).astype(np.float32)
    ref = mrc.read(os.path.join(work, "initial_model.mrc"))
    table = cistem.read_parameters(os.path.join(work, "refined.cistem"))
    ctf = table_to_ctf_params(table)
    params = cli._project_params(REFINE_ARGS[1:], work_dir=work,
                                 persist=False)
    kw = gather_search_kwargs(params, 2, pixel, True)

    def compare(name, single, sharded):
        (a, t_single), (b, t_sharded) = single, sharded
        a = [x for x in a if isinstance(x, torch.Tensor)]
        b = [x for x in b if isinstance(x, torch.Tensor)]
        scale = max(float(x.abs().max()) for x in a)
        err = max(float((x - y).abs().max()) for x, y in zip(a, b))
        row["steps"][name] = {"single_s": t_single, "sharded_s": t_sharded,
                              "max_abs_err": err, "max_abs": scale,
                              "ok": err <= DIST_REL_TOL * scale}

    rows = slice(0, DIST_BATCH)
    single = _sync_s(lambda: refine3d.refine_batch(
        stack[rows], ctf[rows], ref, pixel, device="cuda", **kw))
    kernels.shift_scored_match.launches = 0
    sharded = _sync_s(lambda: parallel.sharded_refine_batch(
        mesh, stack[rows], ctf[rows], ref, pixel, **kw))
    row["launches"] = kernels.shift_scored_match.launches
    compare("sharded_refine_batch", single, sharded)
    poses = table_to_poses(table, pixel)
    compare("reconstruct_sharded",
            _sync_s(lambda: rec.reconstruct(stack, poses, ctf, pixel,
                                            device="cuda")),
            _sync_s(lambda: parallel.reconstruct_sharded(
                mesh, stack, poses, ctf, pixel)))
    c = CSP_LAYERS
    args, gen = _csp_layers_inputs()
    R = csp.effective_rotations(args[0]).reshape(-1, 3, 3)
    B = R.shape[0]
    dev = R.device
    wins = torch.randn((B, c["box"], c["box"]), generator=gen, device=dev)
    mat = (wins, R, torch.zeros((B, 2), device=dev),
           torch.full((B,), 20000.0, device=dev),
           torch.arange(B, device=dev) % 2, torch.ones(B, device=dev),
           c["box"], c["pixel"])
    compare("sharded_accumulate_matrices",
            _sync_s(lambda: rec.accumulate_matrices(*mat)),
            _sync_s(lambda: parallel.sharded_accumulate_matrices(mesh, *mat)))
    offs, spin = csp.build_mode_offsets(c["modes"], None, 9)
    sched = (offs, spin, c["modes"], c["box"], c["pixel"])

    def flat(out):
        return list(out[0]) + [out[1], out[2]]

    single = _sync_s(lambda: csp.csp_refine_batch(
        *args, *sched, iters_per_mode=DIST_CSP_ITERS))
    sharded = _sync_s(lambda: parallel.csp_refine_batch_sharded(
        mesh, *args, *sched, iters_per_mode=DIST_CSP_ITERS))
    compare("csp_refine_batch_sharded", (flat(single[0]), single[1]),
            (flat(sharded[0]), sharded[1]))
    dist.destroy_process_group()
    print(json.dumps(row), flush=True)


def phase_distributed(data, init, slice_ref):
    """The port's multi-GPU path on the one card. (i) A world-size-1 NCCL
    group in a subprocess started through the environment variables runs
    every `parallel` function once at full width (`distributed_one`):
    each equal to its single-device function to DIST_REL_TOL x max, and
    sharded_refine_batch launches shift_scored_match. (ii) The distributed
    script of `refine -slurm_queue q -slurm_nodes 2` + REFINE_ARGS (the
    first two iterations) run by bash as the scheduler would, srun
    starting its two ranks here, each in its own copy of the project: the
    ranks share the card, so the group is gloo; (i) and (ii) run at once.
    Bars: rank 0 alone wrote
    maps/, the poses at iterations 2 and 3 within
    test_torch_refine_pipeline's gather tolerances of the slice phase's
    single-rank run, FSC(0.143) at iteration 2 within one shell of it, and
    every rank launched shift_scored_match. Returns the launches of both
    runs."""
    from pyp_tpu_torch.io import cistem
    from pyp_tpu_torch.tools import e2e_spa
    from pyp_tpu_torch.tools.e2e_spa import SLICE

    failures = []
    row = {"phase": "distributed"}
    with tempfile.TemporaryDirectory() as root:
        one = os.path.join(root, "one")
        os.makedirs(one)
        e2e_spa.write_project(one, data, init, pixel=SLICE["pixel"])
        cistem.write_parameters(slice_ref["tables"][3],
                                os.path.join(one, "refined.cistem"))
        env = {**os.environ, "PYTHONPATH": ROOT,
               "PYP_TPU_COORDINATOR": f"localhost:{_free_port()}",
               "PYP_TPU_NUM_PROCS": "1", "PYP_TPU_PROC_ID": "0",
               "PYP_TPU_LOCAL_RANK": "0", "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
        t0 = time.perf_counter()
        proc = _start_group([sys.executable, os.path.abspath(__file__),
                             "--distributed-one", one], env=env)
        try:
            failures += _two_ranks(data, init, slice_ref, root, row,
                                   SLICE["pixel"], SLICE["box"])
        finally:
            rc, out, err = _finish_group(proc, 600)
        row["one_rank_s"] = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"the world-size-1 NCCL run exited {rc}:\n"
                               f"{out[-3000:]}\n{err[-6000:]}")
        one_row = [json.loads(ln) for ln in out.splitlines()
                   if ln.startswith('{"phase": "distributed_one"')][-1]
        emit(one_row)
        if one_row["backend"] != "nccl" or one_row["world_size"] != 1:
            failures.append(f"(i) ran on {one_row['backend']} x "
                            f"{one_row['world_size']}")
        failures += [f"(i) {k}: {v}" for k, v in one_row["steps"].items()
                     if not v["ok"]]
        if one_row["launches"] < 1:
            failures.append("(i) sharded_refine_batch never launched "
                            "shift_scored_match")
    emit(row)
    if failures:
        raise RuntimeError("distributed bars failed: " + "; ".join(failures))
    return one_row["launches"] + sum(
        rep["launches"]["shift_scored_match"] for rep in row["ranks"])


def _two_ranks(data, init, slice_ref, root, row, pixel=1.0, box=128):
    """(ii) of the distributed phase in `root`: the rows of `row` it
    fills, and the bars it failed."""
    from pyp_tpu_torch.io import cistem
    from pyp_tpu_torch.tools import e2e_spa
    from pyp_tpu_torch.tools.e2e_spa import REFINE_ARGS

    failures = []
    two = os.path.join(root, "two")
    ranks = [os.path.join(two, f"rank{r}") for r in (0, 1)]
    os.makedirs(ranks[0])
    e2e_spa.write_project(ranks[0], data, init, pixel=pixel)
    os.makedirs(ranks[1])
    for f in ("stack.mrc", "stack.cistem", "initial_model.mrc"):
        os.link(os.path.join(ranks[0], f), os.path.join(ranks[1], f))
    argv = list(REFINE_ARGS)
    argv[argv.index("-refine_maxiter") + 1] = DIST_MAXITER
    emitted, _ = _cli_json(argv + ["-slurm_queue", "q", "-slurm_nodes",
                                   "2"], ranks[0])
    script = os.path.join(ranks[0], emitted["script"])
    with open(script) as f:
        row["script"] = f.read().splitlines()
    # the scheduler's part, on this host: srun starts SLURM_NTASKS ranks
    # of its command, each in its own copy of the project
    bin_dir = os.path.join(root, "bin")
    os.makedirs(bin_dir)
    shims = {"scontrol": "#!/bin/bash\necho localhost\n",
             "srun": ("#!/bin/bash\npids=()\n"
                      "for ((i = 0; i < SLURM_NTASKS; i++)); do\n"
                      f'  (cd "{two}/rank$i" && SLURM_PROCID=$i '
                      'SLURM_LOCALID=$i exec "$@") &\n'
                      "  pids+=($!)\ndone\nrc=0\n"
                      'for p in "${pids[@]}"; do wait "$p" || rc=1; done\n'
                      "exit $rc\n")}
    for name, text in shims.items():
        with open(os.path.join(bin_dir, name), "w") as f:
            f.write(text)
        os.chmod(os.path.join(bin_dir, name), 0o755)
    reports = os.path.join(root, "reports")
    env = {**os.environ, "PYTHONPATH": ROOT, "SLURM_NTASKS": "2",
           "SLURM_JOB_NODELIST": "localhost",
           "PATH": bin_dir + os.pathsep + os.environ.get("PATH", ""),
           "PYP_TPU_RANK_REPORT": reports}
    t0 = time.perf_counter()
    rc, out, err = _run_group(["bash", script], 900, cwd=ranks[0],
                              env=env)
    row["two_ranks_s"] = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"the 2-rank refine exited {rc}:\n"
                           f"{out[-3000:]}\n{err[-6000:]}")
    rank_rows = []
    for r in (0, 1):
        with open(os.path.join(reports, f"rank{r}.json")) as f:
            rank_rows.append(json.load(f))
    row["ranks"] = rank_rows
    maps = os.path.join(ranks[0], "maps")
    row["rank1_files"] = sorted(os.listdir(ranks[1]))
    with open(os.path.join(maps, "dataset_r01_history.json")) as f:
        history = {h["iteration"]: h["resolution"] for h in json.load(f)}
    for it in (2, 3):
        mine = cistem.read_parameters(
            os.path.join(maps, f"dataset_r01_{it:02d}.cistem"))
        theirs = slice_ref["tables"][it]
        diff = _rot_diff_deg(mine, theirs)
        row[f"iteration{it}"] = {
            "within_1deg": float(np.mean(diff < 1.0)),
            "median_x_shift_diff_A": float(np.median(np.abs(
                np.asarray(mine["x_shift"])
                - np.asarray(theirs["x_shift"])))),
            "fsc143_A": history[it],
            "slice_fsc143_A": slice_ref["fsc143_A"][it]}
        r = row[f"iteration{it}"]
        if not (r["within_1deg"] >= 0.9 and r["median_x_shift_diff_A"]
                < 0.05 * pixel):
            failures.append(f"(ii) iteration {it} poses: {r}")
    a, b = history[2], slice_ref["fsc143_A"][2]
    if abs(1 / a - 1 / b) > 1.0 / (box * pixel):
        failures.append(f"(ii) FSC(0.143) {a} Å against the slice "
                        f"run's {b} Å")
    if row["rank1_files"] != ["initial_model.mrc", "stack.cistem",
                              "stack.mrc"]:
        failures.append(f"rank 1 wrote into its project: "
                        f"{row['rank1_files']}")
    for rep in row["ranks"]:
        if rep["backend"] != "gloo" or rep["world_size"] != 2:
            failures.append(f"rank {rep['rank']} ran on {rep['backend']} x "
                            f"{rep['world_size']}")
        if rep["launches"]["shift_scored_match"] < 1:
            failures.append(f"rank {rep['rank']} never launched "
                            "shift_scored_match")
    return failures


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


def _cli_json(argv, cwd, last=False):
    """cli.main(argv, device="cuda") run in `cwd` with stdout captured:
    (the JSON object it printed, wall seconds); with `last`, the last of
    the one-line objects (a workflow prints its blocks' first)."""
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
    if last:
        line = [ln for ln in text.splitlines() if ln.startswith("{")][-1]
        return json.loads(line), wall
    # the first JSON object printed (`spr -prism_enable` prints prism's,
    # then the merge's)
    return json.JSONDecoder().raw_decode(text[text.index("{"):])[0], wall


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
    the same call again, which must only resume. Returns the first call's
    seconds per movie."""
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
    return wall / merge["micrographs"]


def phase_slurm(movies_dir, project, root):
    """SLURM submission of `spr`, run here as the scheduler would run it:
    `spr -slurm_queue q -slurm_bundle 2` (no submit) on links to the three
    movies writes the array and its merge; bash runs both elements of
    sprswarm.sbatch at once (each `eval`s its lines of sprswarm.swarm, a
    `worker` per movie), then sprmerge.sbatch (the merge payload through
    `worker`). Bar: every bundle's picks (positions and scores) and
    defocus equal to the spr phase's, bit for bit. Then the launcher,
    built from csrc/launcher.cpp: its `spr` alias execs `python -m
    pyp_tpu_torch.cli spr` (a stub python prints what it was given)."""
    from pyp_tpu_torch.io.metadata import ItemMetadata
    from pyp_tpu_torch.ops import _build
    from pyp_tpu_torch.tools import e2e_spr

    work = os.path.join(root, "slurm")
    movies = os.path.join(work, "movies")
    os.makedirs(movies)
    names = sorted(f[:-4] for f in os.listdir(movies_dir)
                   if f.startswith("movie_") and f.endswith(".mrc"))
    for name in names:
        os.link(os.path.join(movies_dir, name + ".mrc"),
                os.path.join(movies, name + ".mrc"))
    argv = e2e_spr.SPR_ARGS + ["-data_path",
                               os.path.join(movies, "movie_*.mrc"),
                               "-slurm_queue", "q", "-slurm_bundle", "2"]
    report, _ = _cli_json(argv, work)
    env = {**os.environ, "PYTHONPATH": ROOT}
    row = {"phase": "slurm", "n_items": report["n_items"],
           "scripts": [os.path.basename(p) for p in report["scripts"]]}
    t0 = time.perf_counter()
    rc, out, err = _run_group(
        ["bash", "-c", 'SLURM_ARRAY_TASK_ID=1 bash "$0" & a=$!; '
         'SLURM_ARRAY_TASK_ID=2 bash "$0" & b=$!; '
         'wait $a; ra=$?; wait $b; exit $((ra | $?))',
         "swarm/sprswarm.sbatch"], 600, cwd=work, env=env)
    row["elements_s"] = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"the swarm's elements exited {rc}:\n"
                           f"{out[-3000:]}\n{err[-6000:]}")
    t0 = time.perf_counter()
    rc, out, err = _run_group(["bash", "swarm/sprmerge.sbatch"], 300,
                              cwd=work,
                              env={**env, "SLURM_ARRAY_TASK_ID": "1"})
    row["merge_s"] = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"the merge exited {rc}:\n{out[-3000:]}\n"
                           f"{err[-6000:]}")
    failures = []
    row["picks"], row["defocus_max_diff_A"] = {}, 0.0
    for name in names:
        mine = ItemMetadata(name, work).load()
        theirs = ItemMetadata(name, project).load()
        if not (mine.is_done("box") and mine.is_done("ctf")):
            failures.append(f"{name}: no picks or CTF in the bundle")
            continue
        row["picks"][name] = int(len(mine["box"]))
        # the picks' positions and scores, bit for bit: the elements share
        # the card, and nothing on the path may depend on its free memory
        if not np.array_equal(mine["box"], theirs["box"]):
            failures.append(f"{name}: picks differ from the spr phase's")
        row["defocus_max_diff_A"] = max(row["defocus_max_diff_A"], *(
            abs(float(mine["ctf"][k]) - float(theirs["ctf"][k]))
            for k in (0, 1)))
    if row["defocus_max_diff_A"] != 0.0:
        failures.append(f"defocus off the spr phase's by "
                        f"{row['defocus_max_diff_A']} Å")
    # the launcher's alias farm
    t0 = time.perf_counter()
    binary = _build.build_executable("launcher")
    row["launcher_build_s"] = time.perf_counter() - t0
    stub = os.path.join(work, "python-stub")
    with open(stub, "w") as f:
        f.write('#!/bin/sh\necho "$@"\n')
    os.chmod(stub, 0o755)
    alias = os.path.join(work, "spr")
    os.symlink(binary, alias)
    rc, out, err = _run_group([alias, "-data_path", "x"], 60, env={
        **os.environ, "PYP_TPU_PYTHON": stub})
    row["launcher_spr"] = out.strip()
    if rc != 0 or out.split() != ["-m", "pyp_tpu_torch.cli", "spr",
                                  "-data_path", "x"]:
        failures.append(f"the launcher's spr alias gave {rc}: {out!r} "
                        f"{err!r}")
    emit(row)
    if failures:
        raise RuntimeError("slurm bars failed: " + "; ".join(failures))


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


def phase_spr_refine(project, volume, root):
    """The extracted stack and table with a 20 Å low-pass of the truth as
    the starting map through the FRM protocol: movies to a map. Run twice:
    on the stack as `extract` writes it (contrast inverted, the mode's
    default) and on its negative, the micrograph's own contrast, which is
    what the refinement's CTF model (-sin chi) describes. Reported, not
    held to a bar (a few hundred particles). Returns the second run's
    directory (under `root`) and its final FSC(0.143)."""
    import shutil

    from pyp_tpu_torch.io import mrc
    from pyp_tpu_torch.tools import e2e_spa, e2e_spr, profile_refine
    from pyp_tpu_torch.tools.e2e_spa import FRM_ARGS, SLICE

    truth = e2e_spr.with_envelope(volume, e2e_spr.MOVIES["envelope"])
    init = e2e_spa.starting_map(truth, SLICE["pixel"], e2e_spa.START_RESOLUTION)
    stack = mrc.read(os.path.join(project, "stack.mrc"))
    cwd = os.getcwd()
    for contrast, sign in (("as_extracted", 1.0), ("micrograph", -1.0)):
        work = os.path.join(root, f"refine_{contrast}")
        os.makedirs(work)
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
    return work, iters[last]["fsc143_A"]


# ---------------------------------------------------------------------------
# the streaming slice: RELION interchange, the session daemon and the
# workflow runner on the spr phases' movies and project
# ---------------------------------------------------------------------------

INTEROP_EULER_TOL_DEG = 1e-3
INTEROP_SHIFT_TOL_PX = 1e-3
INTEROP_DEFOCUS_TOL_A = 0.1
STREAM_CLASSES = 8
STREAM_WAIT_S = 300.0


def _one_shell_A(fsc_A):
    """The width of one Fourier shell at `fsc_A` for box 128 at 1 Å/px."""
    from pyp_tpu_torch.tools.e2e_spa import SLICE

    return fsc_A ** 2 / (SLICE["box"] * SLICE["pixel"])


def phase_interop(refined, fsc_ref, root):
    """`export_star` of spr_refine's micrograph-contrast run (its final
    table) and `import_star` into a fresh project. Bars: the imported
    table's eulers within 1e-3°, shifts within 1e-3 px and defocus within
    0.1 Å of the exported one; `refine` (FRM, the last two resolution
    limits of the run's protocol, two iterations) from the imported poses
    and the run's final map reaches FSC(0.143) no worse than one shell
    above spr_refine's; `byp` of the .cistem to a .par, read back, equal to
    the .par's printed precision. Returns the kernel launches (0)."""
    import glob
    import shutil

    import torch

    from pyp_tpu_torch.io import cistem, parfile
    from pyp_tpu_torch.ops import kernels
    from pyp_tpu_torch.tools import profile_refine
    from pyp_tpu_torch.tools.e2e_spa import FRM_ARGS, SLICE

    scope = ["-scope_pixel", str(SLICE["pixel"]), "-scope_voltage", "300",
             "-scope_cs", "2.7", "-scope_wgh", "0.07"]
    export = os.path.join(root, "interop_export")
    project = os.path.join(root, "interop_import")
    os.makedirs(export)
    os.makedirs(project)
    tables = sorted(glob.glob(os.path.join(refined, "maps",
                                           "dataset_r01_??.cistem")))
    maps = sorted(glob.glob(os.path.join(refined, "maps",
                                         "dataset_r01_??.mrc")))
    shutil.copy(tables[-1], os.path.join(export, "stack.cistem"))
    kernels.shift_scored_match.launches = 0
    torch.cuda.reset_peak_memory_stats()
    out_e, wall_e = _cli_json(["export_star", "-export_location", "."]
                              + scope, export)
    shutil.copy(os.path.join(export, "particles.star"), project)
    out_i, wall_i = _cli_json(["import_star", "particles.star"], project)
    exported = cistem.read_parameters(os.path.join(export, "stack.cistem"))
    imported = cistem.read_parameters(os.path.join(project, "stack.cistem"))

    def max_diff(cols):
        return max(float(np.abs(np.asarray(imported[c], np.float64)
                                - np.asarray(exported[c], np.float64)).max())
                   for c in cols)

    row = {"phase": "interop", "export_s": wall_e, "import_s": wall_i,
           "particles": out_e["particles"],
           "imported": out_i["particles.star"]["particles"],
           "euler_max_diff_deg": max_diff(("phi", "theta", "psi")),
           "shift_max_diff_px": max_diff(("x_shift", "y_shift"))
           / SLICE["pixel"],
           "defocus_max_diff_A": max_diff(("defocus_1", "defocus_2"))}
    # refinement from the imported poses on the card
    shutil.copy(os.path.join(refined, "stack.mrc"), project)
    shutil.copy(maps[-1], os.path.join(project, "initial_model.mrc"))
    # the resolution limits of the run's last two iterations
    rhref = FRM_ARGS[FRM_ARGS.index("-refine_rhref") + 1].split(":")
    its = [int(os.path.basename(t)[-9:-7]) for t in tables[-2:]]
    last_limits = ":".join(rhref[min(it - 2, len(rhref) - 1)] for it in its)
    argv = list(FRM_ARGS)
    argv[argv.index("-refine_maxiter") + 1] = "2"
    argv[argv.index("-refine_rhref") + 1] = last_limits
    cwd = os.getcwd()
    os.chdir(project)
    try:
        iters, wall_r = _sync_s(lambda: profile_refine.drive(argv, "cuda"))
    finally:
        os.chdir(cwd)
    fsc = iters[max(iters)]["fsc143_A"]
    # .cistem -> .par with byp, read back
    out_b, wall_b = _cli_json(["byp", "stack.cistem"], project)
    back = parfile.to_cistem_table(parfile.read(
        os.path.join(project, out_b["output"])))
    par_err = {c: float(np.abs(np.asarray(back[c], np.float64)
                               - np.asarray(imported[c], np.float64)).max())
               for c in ("phi", "theta", "psi", "x_shift", "y_shift",
                         "defocus_1", "defocus_2")}
    row.update(refine_s=wall_r, refine_rhref=last_limits,
               refine_iterations=sorted(iters), fsc143_A=fsc,
               fsc143_spr_refine_A=fsc_ref, one_shell_A=_one_shell_A(fsc_ref),
               byp_s=wall_b, par_max_diff=par_err,
               max_memory_allocated_GiB=torch.cuda.max_memory_allocated() / 2**30,
               launches=kernels.shift_scored_match.launches)
    emit(row)
    failures = []
    if not row["particles"] == row["imported"] == exported.n_rows:
        failures.append(f"{row['imported']} of {row['particles']} imported")
    for key, bar in (("euler_max_diff_deg", INTEROP_EULER_TOL_DEG),
                     ("shift_max_diff_px", INTEROP_SHIFT_TOL_PX),
                     ("defocus_max_diff_A", INTEROP_DEFOCUS_TOL_A)):
        if not row[key] <= bar:
            failures.append(f"{key} {row[key]} > {bar}")
    if not fsc <= fsc_ref + row["one_shell_A"]:
        failures.append(f"FSC {fsc:.3f} Å from the imported poses against "
                        f"{fsc_ref:.3f} Å")
    # half the last printed digit of the .par columns (%8.2f angles,
    # %10.2f shifts, %9.1f defocus), plus the half float32 spacing that
    # the table's float32 column rounds the printed value by
    for c, tol in (("phi", 5e-3), ("theta", 5e-3), ("psi", 5e-3),
                   ("x_shift", 5e-3), ("y_shift", 5e-3), ("defocus_1", 5e-2),
                   ("defocus_2", 5e-2)):
        half_spacing = 0.5 * float(np.spacing(np.float32(
            np.abs(np.asarray(imported[c], np.float32)).max())))
        if not par_err[c] <= tol + half_spacing:
            failures.append(f".par round trip {c} off by {par_err[c]}")
    if row["launches"]:
        failures.append("interop launched shift_scored_match")
    if failures:
        raise RuntimeError("interop bars failed: " + "; ".join(failures))
    return row["launches"]


def _link_or_copy(src, dst):
    """`dst` appears whole at once: a hard link, else a copy renamed into
    place."""
    import shutil

    try:
        os.link(src, dst)
    except OSError:
        tmp = os.path.join(os.path.dirname(dst), "." + os.path.basename(dst))
        shutil.copy(src, tmp)
        os.replace(tmp, dst)


def _wait_for(check, what, timeout=STREAM_WAIT_S, thread=None):
    t0 = time.perf_counter()
    while not check():
        if thread is not None and not thread.is_alive():
            raise RuntimeError(f"the stream daemon ended before {what}")
        if time.perf_counter() - t0 > timeout:
            raise RuntimeError(f"timed out after {timeout} s waiting for "
                               f"{what}")
        time.sleep(0.1)
    return time.perf_counter() - t0


def phase_stream(movies_dir, project, root, spr_s_per_movie):
    """`cli.main(["stream", ...])` in this process (a thread) on a watch
    directory into which the three movies appear one by one, with the spr
    phase's flags, incremental 2D classification (8 classes) and a file
    metadb. Bars: 3 processed; each movie's particle count and defocus
    equal to the spr phase's bundle of the same movie; classes made, their
    occupancies summing to the particles; the metadb holds 3 micrographs
    and the classes document; a pypd.restart that changes a ctf_ parameter
    re-runs CTF estimation on each movie and neither the alignment nor
    the picking (JAX's `_invalidate`: ctf_force drops the bundles' ctf
    entries only); pypd.stop ends the daemon; `export_session` writes a
    micrographs star of 3 rows and autopick stars holding every pick.
    Reports seconds per movie beside the spr phase's. Returns the kernel
    launches (0)."""
    import threading

    import torch

    from pyp_tpu_torch import cli
    from pyp_tpu_torch.io import star
    from pyp_tpu_torch.io.metadata import ItemMetadata
    from pyp_tpu_torch.ops import kernels
    from pyp_tpu_torch.stream.metadb import MetaDB
    from pyp_tpu_torch.tools import e2e_spr

    watch = os.path.join(root, "stream_watch")
    session = os.path.join(root, "stream_session")
    os.makedirs(watch)
    os.makedirs(session)
    db_path = os.path.join(session, "metadb.json")
    names = sorted(os.path.basename(p)[:-4] for p in
                   os.listdir(movies_dir) if p.endswith(".mrc"))
    names = [n for n in names if n.startswith("movie_")]
    spr_meta = {n: ItemMetadata(n, project).load() for n in names}
    # the classification's particle threshold: all three movies' picks, so
    # that it runs once, when the last movie is in
    class_min = sum(len(m["box"]) for m in spr_meta.values())

    def db():
        return MetaDB(db_path) if os.path.exists(db_path) else None

    def n_micrographs():
        d = db()
        return d.count_micrographs("group", "sess") if d else 0

    argv = (["stream"] + e2e_spr.SPR_ARGS[1:]
            + ["-data_path", os.path.join(watch, "*.mrc"), "-data_set",
               "sess", "-class2d_enable", "-class2d_num",
               str(STREAM_CLASSES), "-class2d_min", str(class_min),
               "-stream_metadb", db_path, "-stream_poll_interval", "0.2"])
    result = {}

    def run():
        try:
            result["rc"] = cli.main(argv, device="cuda")
        except BaseException as e:  # noqa: BLE001 — reported below
            result["error"] = repr(e)

    kernels.shift_scored_match.launches = 0
    torch.cuda.reset_peak_memory_stats()
    cwd = os.getcwd()
    os.chdir(session)          # the daemon's project dir, for the whole run
    thread = threading.Thread(target=run, name="stream-daemon")
    per_movie = []
    try:
        t0 = time.perf_counter()
        thread.start()
        for i, name in enumerate(names):
            _link_or_copy(os.path.join(movies_dir, name + ".mrc"),
                          os.path.join(watch, name + ".mrc"))
            per_movie.append(_wait_for(lambda: n_micrographs() >= i + 1,
                                       f"{name} in the metadb",
                                       thread=thread))
        _wait_for(lambda: db().get_twod_classes("group", "sess") is not None,
                  "the classes document", thread=thread)
        first_pass_s = time.perf_counter() - t0
        bundles = {n: ItemMetadata(n, session).load() for n in names}
        picks = {n: int(len(m["box"])) for n, m in bundles.items()}
        defocus = {n: [float(m["ctf"][0]), float(m["ctf"][1])]
                   for n, m in bundles.items()}
        drift_before = {n: np.asarray(m["drift"]) for n, m in bundles.items()}
        # restart with one ctf_ parameter changed
        with _StageTimes() as stages:
            flag = os.path.join(session, "pypd.restart")
            with open(flag, "w") as f:
                f.write("ctf_max_def = 40001.0\n")
            restart_s = _wait_for(lambda: not os.path.exists(flag),
                                  "the restart", thread=thread)
        (open(os.path.join(session, "pypd.stop"), "w")).close()
        thread.join(timeout=STREAM_WAIT_S)
    finally:
        os.chdir(cwd)
    if thread.is_alive():
        raise RuntimeError("the stream daemon did not stop on pypd.stop")
    launches = kernels.shift_scored_match.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    d = db()
    classes = d.get_twod_classes("group", "sess")
    occ = np.asarray(classes["occupancy"], np.float64)
    ran = [name for name, _ in stages.rows]
    drift_after = {n: np.asarray(ItemMetadata(n, session).load()["drift"])
                   for n in names}
    # the session's RELION export
    export = os.path.join(root, "stream_export")
    os.makedirs(export)
    out_x, wall_x = _cli_json(["export_session", "-data_parent", session],
                              export)
    rel = os.path.join(export, "relion")
    mics = star.read(os.path.join(rel, "sess_micrographs.star"))
    exported_picks = sum(
        len(next(iter(star.read(os.path.join(rel, f"{n}_autopick.star"))
                      .values()))["loop"]["rlnCoordinateX"]) for n in names)
    row = {"phase": "stream", "rc": result.get("rc"),
           "error": result.get("error"), "first_pass_s": first_pass_s,
           "seconds_per_movie": per_movie,
           "spr_seconds_per_movie": spr_s_per_movie,
           "picks": picks,
           "picks_spr": {n: int(len(m["box"])) for n, m in spr_meta.items()},
           "defocus_max_diff_A": max(
               abs(defocus[n][k] - float(spr_meta[n]["ctf"][k]))
               for n in names for k in (0, 1)),
           "classes": len(occ), "class_particles": classes["particles"],
           "occupancy_fraction_sum": float(occ.sum() / classes["particles"]),
           "metadb_micrographs": d.count_micrographs("group", "sess"),
           "session_status": d.get_session("group", "sess")["status"],
           "restart_s": restart_s, "restart_stages": ran,
           "drift_unchanged": all(np.array_equal(drift_before[n],
                                                 drift_after[n])
                                  for n in names),
           "export_session_s": wall_x,
           "exported_micrographs": out_x["micrographs"],
           "exported_picks": exported_picks,
           "max_memory_allocated_GiB": peak, "launches": launches}
    emit(row)
    failures = []
    if row["rc"] != 0 or row["error"]:
        failures.append(f"cli.main(stream) gave {row['rc']} {row['error']}")
    if row["picks"] != row["picks_spr"]:
        failures.append(f"picks {row['picks']} against the spr phase's "
                        f"{row['picks_spr']}")
    if row["defocus_max_diff_A"] != 0.0:
        failures.append(f"defocus off the spr phase's by "
                        f"{row['defocus_max_diff_A']} Å")
    if not (row["classes"] == STREAM_CLASSES
            and abs(row["occupancy_fraction_sum"] - 1.0) < 1e-6
            and row["class_particles"] == sum(picks.values())):
        failures.append(f"classes {row['classes']}, occupancies summing to "
                        f"{row['occupancy_fraction_sum']} of "
                        f"{row['class_particles']} particles")
    if row["metadb_micrographs"] != len(names):
        failures.append(f"the metadb holds {row['metadb_micrographs']} "
                        "micrographs")
    if not (ran.count("CTF estimation") == len(names)
            and "movie alignment" not in ran and "particle picking" not in ran
            and row["drift_unchanged"]):
        failures.append(f"the restart ran {ran}")
    if row["session_status"] != "stopped":
        failures.append(f"session status {row['session_status']}")
    if not (row["exported_micrographs"] == len(mics["micrographs"]["loop"][
            "rlnMicrographName"]) == len(names)
            and row["exported_picks"] == sum(picks.values())):
        failures.append(f"export_session wrote {row['exported_micrographs']} "
                        f"micrographs and {row['exported_picks']} picks")
    if launches:
        failures.append("stream launched shift_scored_match")
    if failures:
        raise RuntimeError("stream bars failed: " + "; ".join(failures))
    return launches


def phase_workflow(movies_dir, refined, fsc_ref, root):
    """`cli.main(["workflow", "workflows/spa_tutorial.toml", ...])` on the
    three movies: raw data -> preprocessing (spr, then extract) ->
    refinement (FRM, 4 iterations) -> postprocessing. The asked arguments
    (-data_path, -scope_pixel) and, appended to every block, the spr
    phase's flags (its -detect_rad 45 overrides the file's 75),
    -no_extract_inv, -model_path (spr_refine's 20 Å start) and the
    reference's FRM protocol (FRM_ARGS, whose engine and iterations are
    the file's), so the refinement is spr_refine's micrograph-contrast run.
    Bars: every block rc 0 and the refined map's FSC(0.143) no worse than
    one shell above that run's. Reports the wall per block. Returns the
    kernel launches (0)."""
    import torch

    from pyp_tpu_torch import cli
    from pyp_tpu_torch.ops import kernels
    from pyp_tpu_torch.tools import e2e_spr
    from pyp_tpu_torch.tools.e2e_spa import FRM_ARGS, SLICE

    work = os.path.join(root, "workflow")
    os.makedirs(work)
    argv = (["workflow", os.path.join(ROOT, "workflows", "spa_tutorial.toml"),
             "-data_path", os.path.join(movies_dir, "movie_*.mrc"),
             "-scope_pixel", str(SLICE["pixel"])]
            + e2e_spr.SPR_ARGS[1:] + FRM_ARGS[1:]
            + ["-no_extract_inv", "-model_path",
               os.path.join(refined, "initial_model.mrc")])
    blocks = []
    real_main = cli.main

    def timed_main(args, device="cuda"):
        rc, wall = _sync_s(lambda: real_main(args, device=device))
        blocks.append({"mode": args[0], "rc": rc, "seconds": wall})
        return rc

    kernels.shift_scored_match.launches = 0
    torch.cuda.reset_peak_memory_stats()
    cli.main = timed_main      # the runner calls cli.main for each block
    try:
        out, wall = _cli_json(argv, work, last=True)
    finally:
        cli.main = real_main
    blocks = [b for b in blocks if b["mode"] != "workflow"]
    with open(os.path.join(work, "maps", "dataset_r01_history.json")) as f:
        history = json.load(f)
    fsc = float(history[-1]["resolution"])
    row = {"phase": "workflow", "seconds": wall, "blocks": out["blocks"],
           "block_walls": blocks, "iterations": [h["iteration"]
                                                 for h in history],
           "fsc143_A": fsc, "fsc143_spr_refine_A": fsc_ref,
           "one_shell_A": _one_shell_A(fsc_ref),
           "max_memory_allocated_GiB": torch.cuda.max_memory_allocated() / 2**30,
           "launches": kernels.shift_scored_match.launches}
    emit(row)
    modes = [b["mode"] for b in out["blocks"]]
    if modes != ["params", "spr", "refine", "postprocess"] or any(
            b["rc"] for b in out["blocks"] + blocks):
        raise RuntimeError(f"workflow blocks {out['blocks']} ({blocks})")
    if not fsc <= fsc_ref + row["one_shell_A"]:
        raise RuntimeError(f"workflow: FSC {fsc:.3f} Å against spr_refine's "
                           f"{fsc_ref:.3f} Å")
    if row["launches"]:
        raise RuntimeError("workflow launched shift_scored_match")
    return row["launches"]


def _lzw_encode(data: bytes) -> bytes:
    """A minimal TIFF-LZW encoder (a copy of the test encoder of
    tests/test_native.py), to write the check's movie."""
    CLEAR, EOI = 256, 257
    table = {bytes([i]): i for i in range(256)}
    next_code, code_size = 258, 9
    out_bits = [(CLEAR, code_size)]
    w = b""
    for ch in data:
        wc = w + bytes([ch])
        if wc in table:
            w = wc
        else:
            out_bits.append((table[w], code_size))
            if next_code < 4096:
                table[wc] = next_code
                next_code += 1
                if next_code + 1 > (1 << code_size) and code_size < 12:
                    code_size += 1
            else:
                out_bits.append((CLEAR, code_size))
                table = {bytes([i]): i for i in range(256)}
                next_code, code_size = 258, 9
            w = bytes([ch])
    if w:
        out_bits.append((table[w], code_size))
    out_bits.append((EOI, code_size))
    buf = cnt = 0
    out = bytearray()
    for code, size in out_bits:
        buf = (buf << size) | code
        cnt += size
        while cnt >= 8:
            out.append((buf >> (cnt - 8)) & 0xFF)
            cnt -= 8
    if cnt:
        out.append((buf << (8 - cnt)) & 0xFF)
    return bytes(out)


def _write_lzw_tiff(path, strips, pages, shape, rows_per_strip):
    """A classic little-endian TIFF of `pages` int8 pages (SampleFormat 2)
    of `shape`, each made of the same LZW `strips` of `rows_per_strip`
    rows."""
    import struct

    ny, nx = shape
    body, offsets = b"".join(strips), []
    pos = 8
    for s in strips:
        offsets.append(pos)
        pos += len(s)
    n = len(strips)
    # strip offsets and byte counts as LONG arrays after the strips
    arrays = (struct.pack(f"<{n}I", *offsets)
              + struct.pack(f"<{n}I", *map(len, strips)))
    ifd_at = pos + len(arrays)
    ifds = b""
    for i in range(pages):
        tags = [(256, 4, 1, nx), (257, 4, 1, ny), (258, 3, 1, 8),
                (259, 3, 1, 5),
                (273, 4, n, offsets[0] if n == 1 else pos),
                (278, 4, 1, rows_per_strip),
                (279, 4, n, len(strips[0]) if n == 1 else pos + 4 * n),
                (339, 3, 1, 2)]
        nxt = ifd_at + len(ifds) + 2 + 12 * len(tags) + 4
        ifds += struct.pack("<H", len(tags)) + b"".join(
            struct.pack("<HHII", t, typ, cnt, v) for t, typ, cnt, v in tags
        ) + struct.pack("<I", nxt if i + 1 < pages else 0)
    with open(path, "wb") as f:
        f.write(b"II" + struct.pack("<HI", 42, ifd_at) + body + arrays
                + ifds)


def phase_tiff_lzw():
    """A 4 x 1024² int8 LZW TIFF movie (counts ~ Poisson(1), four strips of
    256 rows per frame; the four frames are one frame encoded once, the
    encoder being pure Python) read by `io/tiff` through the native pypio
    library; the Python decoder's route on the frame's first strip alone
    (a file of that one strip: the pure-Python decoder takes tens of
    seconds for a frame). MB/s of each route, arrays equal to the frames.
    Fails where the library did not build."""
    from pyp_tpu_torch.io import native, tiff

    rng = np.random.RandomState(0)
    frame = rng.poisson(1.0, (1024, 1024)).astype(np.int8)
    rows = 256
    with tempfile.TemporaryDirectory() as d:
        movie, strip = os.path.join(d, "movie.tif"), os.path.join(d, "strip.tif")
        strips, encode_s = _sync_s(lambda: [
            _lzw_encode(frame[r:r + rows].tobytes())
            for r in range(0, 1024, rows)])
        _write_lzw_tiff(movie, strips, 4, frame.shape, rows)
        _write_lzw_tiff(strip, strips[:1], 1, (rows, 1024), rows)
        size = os.path.getsize(movie)
        if not native.available():
            raise RuntimeError("the native pypio library did not build")
        before = dict(tiff.LZW_ROUTES)
        fast, native_s = _sync_s(lambda: tiff.read(movie))
        fast_strip = tiff.read(strip)
        with native.python_only():
            slow, python_s = _sync_s(lambda: tiff.read(strip))
    routes = {k: tiff.LZW_ROUTES[k] - before[k] for k in before}
    row = {"phase": "tiff_lzw", "frames": list(fast.shape),
           "file_bytes": size, "encode_s": encode_s,
           "native_s": native_s, "native_MB_per_s": fast.nbytes / 1e6 / native_s,
           "python_s": python_s, "python_bytes": slow.nbytes,
           "python_MB_per_s": slow.nbytes / 1e6 / python_s,
           "routes": routes,
           "equal": bool(np.array_equal(fast, np.stack([frame] * 4))
                         and np.array_equal(slow, frame[None, :rows])
                         and np.array_equal(fast_strip, slow))}
    emit(row)
    if routes != {"native": 17, "python": 1} or not row["equal"]:
        raise RuntimeError(f"LZW TIFF read: routes {routes}, equal "
                           f"{row['equal']}")


def phase_preprocess(volume):
    """The preprocessing phases on one movie set in a temporary directory
    (`spr` also through SLURM's scripts, `slurm`), the SPA side of the
    models, the streaming slice's phases (interop,
    stream, workflow), then polishing. Returns the kernel launches of the
    `polish`, models, interop, stream and workflow runs."""
    with tempfile.TemporaryDirectory() as root:
        movies_dir = os.path.join(root, "movies")
        project = os.path.join(root, "project")
        truth = phase_spr_synthesize(volume, movies_dir)
        spr_s_per_movie = phase_spr(movies_dir, project, truth)
        phase_slurm(movies_dir, project, root)
        phase_spr_layers(movies_dir)
        phase_extract(project, truth)
        models = phase_models_spr(project, movies_dir, truth, root)
        refined, fsc = phase_spr_refine(project, volume, root)
        launches = {
            "interop": phase_interop(refined, fsc, root),
            "stream": phase_stream(movies_dir, project, root,
                                   spr_s_per_movie),
            "workflow": phase_workflow(movies_dir, refined, fsc, root)}
        return {"polish": phase_polish(project, refined, movies_dir, fsc,
                                       volume), "models_spr": models,
                **launches}

# ---------------------------------------------------------------------------
# tomography: tools/e2e_tomo's series through cli.main(["tomo", ...])
# ---------------------------------------------------------------------------

TOMO_AXIS_BAR_DEG = 0.5        # axis angle within 0.5° of the planted 3°
TOMO_SHIFT_BAR_PX = 1.0        # median per-tilt shift error, binned px
TOMO_DEFOCUS_BAR_REL = 0.02    # mean defocus within 2%
TOMO_CC_BAR = 0.6              # tomogram vs truth, central slab
TOMO_RECALL_BAR = 0.8          # picks within one particle radius
TOMO_MIN_BEADS = 4
TOMO_VIRION_CENTRE_BAR_VOX = 2.0
TOMO_VIRION_RADIUS_BAR_REL = 0.10
TOMO_SHEET_BAR = 0.5           # share of the sheet's voxels in the mask
TOMO_FILAMENT_READ_VOX = 2.0   # the picks' median distance to the rod, read
TOMO_ALI_BIN, TOMO_REC_PIXEL = 4, 8.0   # the schema's binnings at 1 Å/px
TOMO_SLAB_HALF = 16            # the central slab: +-16 of 256 slices
TOMO_MAX_OFFSET_VOX = 4        # the alignment's gauge: a global shift


class _TomoTruth:
    """The planted series and its truth tomogram on the reconstruction
    grid, with the tomogram's gauge offset (the integer 3D shift that best
    superposes it on the truth) from the `tomo` run."""

    def __init__(self, truth):
        self.truth = truth
        self.volume = None
        self.offset = (0, 0, 0)

    def tomogram_truth(self, shape):
        from pyp_tpu_torch.tools import e2e_tomo

        if self.volume is None or tuple(self.volume.shape) != tuple(shape):
            self.volume = e2e_tomo.truth_tomogram(self.truth, shape,
                                                  TOMO_REC_PIXEL)
        return self.volume

    def voxels(self, points_a, shape):
        from pyp_tpu_torch.tools import e2e_tomo

        return (e2e_tomo.rec_voxel(points_a, shape, TOMO_REC_PIXEL)
                + np.asarray(self.offset))


def _tomo_meta(project):
    from pyp_tpu_torch.io.metadata import ItemMetadata

    return ItemMetadata("ts01", project, mode="tomo").load()


def _tomo_alignment(meta, truth, failures, tag):
    """The alignment and CTF bars on a bundle: a dict of the readings."""
    from pyp_tpu_torch.tools import e2e_tomo

    xf, ctf = meta["xf"], meta["ctf"]
    err = e2e_tomo.shift_errors_px(xf, truth, TOMO_ALI_BIN,
                                   meta.scalars["xf_shift_sign"])
    row = {"axis_angle_deg": float(xf[0, 2]),
           "axis_planted_deg": truth["axis_angle"],
           "axis_err_deg": e2e_tomo.axis_error_deg(xf, truth),
           "shift_err_median_px": float(np.median(err)),
           "shift_err_max_px": float(err.max()),
           "mean_defocus_A": float(np.mean(ctf[:, :2])),
           "mean_defocus_planted_A": float(np.mean(truth["defoci"])),
           "defocus_rel_err": e2e_tomo.defocus_rel_error(ctf, truth)}
    for key, ok in (("axis_err_deg", row["axis_err_deg"] <= TOMO_AXIS_BAR_DEG),
                    ("shift_err_median_px",
                     row["shift_err_median_px"] < TOMO_SHIFT_BAR_PX),
                    ("defocus_rel_err",
                     row["defocus_rel_err"] < TOMO_DEFOCUS_BAR_REL)):
        if not ok:
            failures.append(f"{tag}: {key} = {row[key]}")
    return row


def _tomo_cc(path, tt, failures, tag, find_offset=False):
    """cc of a written tomogram with the truth in the central slab."""
    import torch

    from pyp_tpu_torch.io import mrc
    from pyp_tpu_torch.tools import e2e_tomo

    rec = mrc.read(path).astype(np.float32)
    truth_vol = tt.tomogram_truth(rec.shape)
    rec = torch.as_tensor(rec, device=truth_vol.device)
    if find_offset:
        tt.offset = e2e_tomo.best_offset(rec, truth_vol, TOMO_MAX_OFFSET_VOX)
    cc = e2e_tomo.slab_cc(rec, truth_vol, tt.offset, half=TOMO_SLAB_HALF)
    if not np.isfinite(rec.cpu().numpy()).all():
        failures.append(f"{tag}: non-finite tomogram")
    if not cc > TOMO_CC_BAR:
        failures.append(f"{tag}: tomogram cc {cc:.4f} not above {TOMO_CC_BAR}")
    return cc, tuple(rec.shape)


def _fork(base, dst, drop=("box",)):
    """A copy of the `tomo` project whose bundle lacks `drop` (no flag
    forces the picking again)."""
    import shutil

    shutil.copytree(base, dst)
    path = os.path.join(dst, "ts01.meta.npz")
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files if k not in drop}
    np.savez_compressed(path, **arrays)
    return dst


def phase_tomo_synthesize(data_dir):
    from pyp_tpu_torch.tools import e2e_tomo

    (truth, nbytes), seconds = _sync_s(lambda: e2e_tomo.write_series(
        data_dir, device="cuda", **e2e_tomo.SERIES))
    emit({"phase": "tomo_synthesize", "seconds": seconds, "bytes": nbytes,
          "tilts": len(truth["angles"]), "size": truth["size"],
          "particles_planted": len(truth["particles"]),
          "virions_planted": len(truth["virions"]),
          "beads_planted": len(truth["beads"])})
    return _TomoTruth(truth)


def phase_tomo(data_dir, root, tt):
    """`tomo` at the schema's defaults plus -tomo_spk_method auto on
    ts01.mrc + .tlt, held to the planted truth; then the same call again,
    which must only resume. Returns (kernel launches, project)."""
    import torch

    from pyp_tpu_torch.ops import kernels
    from pyp_tpu_torch.tools import e2e_tomo

    project = os.path.join(root, "tomo")
    os.makedirs(project)
    argv = e2e_tomo.TOMO_ARGS + ["-data_path", os.path.join(data_dir, "ts01.mrc")]
    kernels.shift_scored_match.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with _StageTimes() as stages:
        merge, wall = _cli_json(argv, project)
    launches = kernels.shift_scored_match.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    failures = []
    meta = _tomo_meta(project)
    row = {"phase": "tomo", "seconds": wall, "launches": launches,
           "max_memory_allocated_GiB": peak,
           "stages_s": dict(stages.rows), "particles": merge["particles"],
           **_tomo_alignment(meta, tt.truth, failures, "tomo")}
    cc, shape = _tomo_cc(os.path.join(project, "ts01.rec.mrc"), tt, failures,
                         "tomo", find_offset=True)
    planted = tt.voxels(tt.truth["particles"], shape)
    rad = tt.truth["particle_radius"] / TOMO_REC_PIXEL
    row.update(tomogram_shape=list(shape), tomogram_cc=cc,
               gauge_offset_vox=list(tt.offset),
               recall=e2e_tomo.recall(meta["box"][:, :3], planted, rad),
               picks=int(len(meta["box"])), planted=len(planted),
               tilt_panel=os.path.exists(os.path.join(project, "ts01_tilts.png")))
    if not row["recall"] >= TOMO_RECALL_BAR:
        failures.append(f"tomo: recall {row['recall']:.3f}")
    with _StageTimes() as again:
        merge2, wall2 = _cli_json(argv, project)
    row.update(resume_seconds=wall2, resume_stages_run=len(again.rows))
    emit(row)
    if again.rows or merge2 != merge:
        failures.append(f"the second call ran {again.rows} or merged {merge2}")
    if not wall2 < RESUME_BAR * wall:
        failures.append(f"the resumed call took {wall2:.2f} s, not under "
                        f"{RESUME_BAR} of {wall:.2f} s")
    if launches:
        failures.append(f"tomo launched shift_scored_match {launches} times")
    if failures:
        raise RuntimeError("tomo bars failed: " + "; ".join(failures))
    return launches, project


class _Handedness:
    """Collects the pipeline's "defocus handedness" log lines."""

    def __init__(self):
        import logging

        outer = self
        self.hands = []

        class Handler(logging.Handler):
            def emit(self, record):
                msg = record.getMessage()
                if "defocus handedness" in msg:
                    outer.hands.append(int(msg.rsplit(" ", 1)[-1]))

        self.handler = Handler()
        self.logger = logging.getLogger("pyp_tpu_torch.tomo")

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        return False


def phase_tomo_options(data_dir, root, tt, base):
    """The options of `pipeline/tomo`, each in its own project: (a) a
    fiducial alignment with bead erasure, dose weighting, CTF phase
    flipping, handedness and halves from scratch; the others from a copy
    of `tomo`'s bundle: (b) SART, (c) surface picking, (d) template
    matching, (e) filament picking, (f) membrane segmentation, (g) the
    classical denoisers and the deconvolution."""
    from pyp_tpu_torch.io import mrc
    from pyp_tpu_torch.tools import e2e_tomo

    failures = []
    truth = tt.truth
    data = ["-data_path", os.path.join(data_dir, "ts01.mrc")]

    # (a) from scratch
    proj = os.path.join(root, "opt_a")
    os.makedirs(proj)
    flags = ["-tomo_ali_fiducial", "10", "-tomo_rec_erase_fiducials",
             "-tomo_rec_dose_weighting", "-tomo_rec_ctf_correct",
             "-tomo_hand_detect", "-tomo_rec_generate_halves"]
    with _Handedness() as hd, _StageTimes() as stages:
        _, wall = _cli_json(e2e_tomo.TOMO_ARGS + data + flags, proj)
    meta = _tomo_meta(proj)
    beads = int(len(meta["fid"])) if meta.is_done("fid") else 0
    row = {"phase": "tomo_options", "option": "a_fiducial", "seconds": wall,
           "stages_s": dict(stages.rows), "beads": beads,
           "handedness": hd.hands, "hand_planted": truth["hand"],
           "halves": all(os.path.exists(os.path.join(proj, f"ts01.rec_{h}.mrc"))
                         for h in ("half1", "half2")),
           **_tomo_alignment(meta, truth, failures, "a_fiducial")}
    emit(row)
    if beads < TOMO_MIN_BEADS:
        failures.append(f"a_fiducial: {beads} beads")
    if hd.hands != [truth["hand"]]:
        failures.append(f"a_fiducial: handedness {hd.hands}")
    if not row["halves"]:
        failures.append("a_fiducial: halves not written")

    def run(tag, argv, drop=("box",)):
        proj = _fork(base, os.path.join(root, tag), drop)
        with _StageTimes() as stages:
            _, wall = _cli_json(["tomo"] + argv, proj)
        return proj, wall, dict(stages.rows)

    # (b) SART
    proj, wall, st = run("opt_b", ["-tomo_rec_method", "sart", "-tomo_rec_force"],
                         drop=())
    cc, _ = _tomo_cc(os.path.join(proj, "ts01.rec.mrc"), tt, failures, "b_sart")
    emit({"phase": "tomo_options", "option": "b_sart", "seconds": wall,
          "stages_s": st, "tomogram_cc": cc})

    shape = tuple(tt.volume.shape)
    # (c) surface picking: the planted virions' centres and radii. The
    # centre read is the centroid of the refined surface's picks nearest
    # each planted virion (the `vir` row keeps the integer centre of the
    # sphere detection, reported beside it), the radius the `vir` row's
    # mean refined radius
    proj, wall, st = run("opt_c", ["-tomo_spk_method", "surface",
                                   "-tomo_vir_rad", "300",
                                   "-tomo_vir_search_band", "0.5",
                                   "-tomo_vir_detect_max", "16"])
    vrow, ok = _virion_errors(_tomo_meta(proj), truth, tt, shape)
    emit({"phase": "tomo_options", "option": "c_surface", "seconds": wall,
          "stages_s": st, **vrow})
    if not ok:
        failures.append(f"c_surface: centre errors "
                        f"{vrow['surface_centre_err_vox']}, radius errors "
                        f"{vrow['radius_rel_err']}")

    # (d) template matching against the planted particle at 30°
    ref = os.path.join(root, "particle.mrc")
    mrc.write(e2e_tomo.particle_map(truth, 32, TOMO_REC_PIXEL).cpu().numpy(),
              ref, pixel_size=TOMO_REC_PIXEL)
    proj, wall, st = run("opt_d", ["-tomo_spk_method", "template",
                                   "-tomo_pick_ref", ref])
    box = _tomo_meta(proj)["box"]
    rec = e2e_tomo.recall(box[:, :3], tt.voxels(truth["particles"], shape),
                          truth["particle_radius"] / TOMO_REC_PIXEL)
    emit({"phase": "tomo_options", "option": "d_template", "seconds": wall,
          "stages_s": st, "picks": int(len(box)), "recall": rec})
    if not rec >= TOMO_RECALL_BAR:
        failures.append(f"d_template: recall {rec:.3f}")

    # (e) filament picking: picks with a tangent prior each, inside the
    # volume. Their median distance to the planted axis is read against
    # 2 voxels without failing the phase: the reference's Frangi picker,
    # which both packages run, misses the rod in this crowded tomogram
    # (tests/test_torch_template_match.py holds both packages to the same
    # picks on this series at half resolution; ROADMAP Queue 3)
    proj, wall, st = run("opt_e", ["-tomo_spk_method", "filament"])
    meta = _tomo_meta(proj)
    box = meta["box"]
    f = truth["filament"]
    p0, p1 = tt.voxels([f["p0"], f["p1"]], shape)
    dist = e2e_tomo.distance_to_segment(box[:, :3], p0, p1)
    med = float(np.median(dist)) if len(dist) else float("inf")
    at_face = ((box[:, :3] < 1) | (box[:, :3] > np.array(shape) - 2)).any(1)
    emit({"phase": "tomo_options", "option": "e_filament", "seconds": wall,
          "stages_s": st, "picks": int(len(box)), "median_distance_vox": med,
          "median_within_2_vox": med <= TOMO_FILAMENT_READ_VOX,
          "picks_within_2_vox": int((dist <= 2.0).sum()),
          "picks_at_faces": int(at_face.sum())})
    inside = ((box[:, :3] >= 0) & (box[:, :3] <= np.array(shape) - 1)).all()
    if not (len(box) and inside and meta["spk_eulers"].shape == (len(box), 3)):
        failures.append(f"e_filament: {len(box)} picks, inside {inside}")

    # (f) membrane segmentation: the planted sheet inside the mask
    proj, wall, st = run("opt_f", ["-tomo_seg_open"], drop=())
    mask = mrc.read(os.path.join(proj, "ts01.seg.mrc")) > 0.5
    sheet = np.roll(e2e_tomo.sheet_voxels(truth, shape, TOMO_REC_PIXEL),
                    tt.offset, (0, 1, 2))
    inside = float(mask[sheet].mean())
    emit({"phase": "tomo_options", "option": "f_segmentation", "seconds": wall,
          "stages_s": st, "sheet_voxels": int(sheet.sum()),
          "sheet_inside": inside, "membrane_fraction": float(mask.mean())})
    if not inside >= TOMO_SHEET_BAR:
        failures.append(f"f_segmentation: {inside:.3f} of the sheet inside")

    # (g) the denoisers: finite volumes, walls reported
    for method in ("bm4d", "nad", "deconv"):
        proj, wall, st = run(f"opt_g_{method}",
                             ["-denoise_method", method, "-tomo_rec_force"],
                             drop=())
        den = mrc.read(os.path.join(proj, "ts01.den.mrc"))
        emit({"phase": "tomo_options", "option": f"g_{method}",
              "seconds": wall, "stages_s": st, "finite": bool(np.isfinite(den).all())})
        if not np.isfinite(den).all():
            failures.append(f"g_{method}: non-finite volume")
    if failures:
        raise RuntimeError("tomo_options bars failed: " + "; ".join(failures))


def phase_tomo_mdoc(root, tt):
    """The .mdoc path: 41 tilt movies of 4 frames x 4096² through
    assemble_tilt_series, then the alignment and CTF bars."""
    import glob

    from pyp_tpu_torch.tools import e2e_tomo

    movies = os.path.join(root, "mdoc")
    (_, nbytes), synth_s = _sync_s(lambda: e2e_tomo.write_series(
        movies, movies=True, device="cuda", **e2e_tomo.SERIES))
    proj = os.path.join(root, "mdoc_project")
    os.makedirs(proj)
    argv = e2e_tomo.TOMO_ARGS + ["-data_path",
                                 os.path.join(movies, "*.mdoc")]
    with _StageTimes() as stages:
        _, wall = _cli_json(argv, proj)
    failures = []
    st = dict(stages.rows)
    n = len(glob.glob(os.path.join(movies, "ts01_*.mrc")))
    row = {"phase": "tomo_mdoc", "synthesize_s": synth_s, "bytes": nbytes,
           "movies": n, "seconds": wall, "stages_s": st,
           "s_per_tilt_movie": st.get("tilt-series assembly", np.nan) / n,
           **_tomo_alignment(_tomo_meta(proj), tt.truth, failures, "mdoc")}
    emit(row)
    if failures:
        raise RuntimeError("tomo_mdoc bars failed: " + "; ".join(failures))


def wbp_bound_ms(T, nz, ny, nx):
    """(bound, bytes bound, operations bound) in ms of a backprojection of
    T tilts (ny, nx) into (nz, ny, nx): each tilt read once and the volume
    written once at the HBM rate; per voxel and tilt ~6 FP32 operations
    (x' by two multiply-adds, the two-tap interpolation and the
    accumulation by two more) at the FP32 peak."""
    mem = 1e3 * 4.0 * (T * ny * nx + nz * ny * nx) / HBM_BYTES_S
    ops = 1e3 * 6.0 * T * nz * ny * nx / FP32_FLOPS
    return max(mem, ops), mem, ops


def phase_tomo_layers(data_dir, tt):
    """Each tomography layer's time at full size on ts01 (device-
    synchronised medians), WBP also at the reference bench's shape."""
    import torch

    from pyp_tpu_torch.core.fft import bin_images
    from pyp_tpu_torch.io import mrc
    from pyp_tpu_torch.ops import ctf_fit, denoise_classic
    from pyp_tpu_torch.ops import template_match as tm
    from pyp_tpu_torch.ops import tomo
    from pyp_tpu_torch.pipeline.spr import _upload
    from pyp_tpu_torch.tools import e2e_tomo

    truth = tt.truth
    ang = np.asarray(truth["angles"], np.float32)
    raw, load_s = _sync_s(lambda: mrc.read(os.path.join(data_dir, "ts01.mrc")))
    tilts, upload_s = _sync_s(lambda: _upload(raw, "cuda"))
    del raw
    tb, bin_s = _sync_s(lambda: bin_images(tilts, TOMO_ALI_BIN))
    t2 = bin_images(tb, 2)
    T, n = tb.shape[0], tb.shape[-1]
    row = {"phase": "tomo_layers", "tilts": list(tilts.shape),
           "load_s": load_s, "upload_s": upload_s, "bin4_s": bin_s}
    row["prealign_ms"] = _median_ms(
        lambda: tomo.prealign_tilt_series(tb, ang), reps=3)
    shifts = tomo.prealign_tilt_series(tb, ang)
    g = np.linspace(n * 0.25, n * 0.75, 3)
    centers = np.array([(y, x) for y in g for x in g], np.float32)
    row["track_patches_ms"] = _median_ms(lambda: tomo.track_patches(
        tb, shifts, ang, centers, patch_size=64), reps=3)
    tracks = tomo.track_patches(tb, shifts, ang, centers, patch_size=64)
    _, row["solve_projection_model_robust_s"] = _sync_s(
        lambda: tomo.solve_projection_model_robust(tracks, ang, (n, n)))
    torch.cuda.reset_peak_memory_stats()
    _, row["fit_ctf_tilt_series_s"] = _sync_s(lambda: ctf_fit.fit_ctf_tilt_series(
        tilts, 1.0, tile=512, dfmin=20000.0, dfmax=50000.0, dfstep=250.0,
        min_res=30.0, max_res=8.0))
    row["fit_ctf_peak_GiB"] = torch.cuda.max_memory_allocated() / 2**30
    del tilts
    for tag, stack, nz in (("default", t2, 256), ("bench", tb, 256)):
        torch.cuda.reset_peak_memory_stats()
        ms = _median_ms(lambda: tomo.wbp_reconstruct(stack, ang, thickness=nz),
                        reps=5)
        bound, mem, ops = wbp_bound_ms(T, nz, *stack.shape[-2:])
        row[f"wbp_{tag}"] = {
            "shape_in": list(stack.shape), "shape_out": [nz, *stack.shape[-2:]],
            "ms": ms, "voxels_per_s": nz * stack.shape[-2] * stack.shape[-1] / (ms / 1e3),
            "bound_ms": bound, "bound_bytes_ms": mem, "bound_ops_ms": ops,
            "peak_GiB": torch.cuda.max_memory_allocated() / 2**30}
    vol = tomo.wbp_reconstruct(t2, ang, thickness=256)
    _, row["sart_reconstruct_s"] = _sync_s(lambda: tomo.sart_reconstruct(
        t2, ang, thickness=256, iterations=10))
    df = np.asarray(truth["defoci"], np.float32)
    row["ctf_correct_tilts_ms"] = _median_ms(lambda: tomo.ctf_correct_tilts(
        t2, ang, df, TOMO_REC_PIXEL), reps=3)
    tpl = e2e_tomo.particle_map(truth, 32, TOMO_REC_PIXEL)
    rots = np.array([[0, 0, 0], [30, 30, 0], [60, 90, 30], [90, 120, 60]],
                    np.float32)
    row["match_template_3d_ms_per_rotation"] = _median_ms(
        lambda: tm.match_template_3d(vol, tpl, rots), reps=3) / len(rots)
    vrad = 300.0 / TOMO_REC_PIXEL
    radii = np.linspace(0.75 * vrad, 1.25 * vrad, 5)
    _, row["detect_spheres_s"] = _sync_s(lambda: tm.detect_spheres(vol, radii, 8))
    v = truth["virions"][0]
    c = e2e_tomo.rec_voxel([v["centre"]], vol.shape, TOMO_REC_PIXEL)[0]
    _, row["refine_surface_sh_s_per_virion"] = _sync_s(lambda: tm.refine_surface_sh(
        vol, c, v["radius"] / TOMO_REC_PIXEL, n_points=200, l_max=4))
    _, row["nlm_denoise_3d_s"] = _sync_s(lambda: denoise_classic.nlm_denoise_3d(vol))
    emit(row)
    return row


def phase_tomo_thick(root):
    """`tomo` on `tools/e2e_tomo.THICK_SERIES`, the same field with its
    content spread through the thickness: the CTF bar holds (defocus does
    not depend on the alignment); the alignment, tomogram and recall are
    read without bars, the known limit of patch tracking (PERF.md §7)."""
    from pyp_tpu_torch.tools import e2e_tomo

    data_dir = os.path.join(root, "thick")
    (truth, _), synth_s = _sync_s(lambda: e2e_tomo.write_series(
        data_dir, device="cuda", **e2e_tomo.THICK_SERIES))
    tt = _TomoTruth(truth)
    proj = os.path.join(root, "thick_project")
    os.makedirs(proj)
    _, wall = _cli_json(e2e_tomo.TOMO_ARGS + [
        "-data_path", os.path.join(data_dir, "ts01.mrc")], proj)
    meta = _tomo_meta(proj)
    unbarred = []
    row = {"phase": "tomo_thick", "synthesize_s": synth_s, "seconds": wall,
           **_tomo_alignment(meta, truth, unbarred, "thick")}
    cc, shape = _tomo_cc(os.path.join(proj, "ts01.rec.mrc"), tt, unbarred,
                         "thick", find_offset=True)
    rad = truth["particle_radius"] / TOMO_REC_PIXEL
    row.update(tomogram_cc=cc, gauge_offset_vox=list(tt.offset),
               recall=e2e_tomo.recall(meta["box"][:, :3],
                                      tt.voxels(truth["particles"], shape), rad),
               picks=int(len(meta["box"])), unbarred_misses=unbarred)
    emit(row)
    if not row["defocus_rel_err"] < TOMO_DEFOCUS_BAR_REL:
        raise RuntimeError(f"tomo_thick: defocus_rel_err = {row['defocus_rel_err']}")
    if any("non-finite" in m for m in unbarred):
        raise RuntimeError("tomo_thick: non-finite tomogram")


# ---------------------------------------------------------------------------
# subtomogram averaging: CSP (tools/e2e_csp on the tomo phase's bundle), the
# legacy SVA on its tomogram, and particle polishing on the SPA movies
# ---------------------------------------------------------------------------

# the reference bench's CSP shape (bench.py:203-275): 8 series x 41 tilts x
# 128 particles, box 64 at 2 Å/px, the 60-8 Å band, modes 3:0:2:1, 20 steps
CSP_LAYERS = dict(S=8, T=41, P=128, box=64, pixel=2.0, band=(60.0, 8.0),
                  modes=(3, 0, 2, 1), iters=20)
CSP_LAYERS_GRID = {3: 10.0, 0: (2.0, 0.0), 2: 10.0, 1: (10.0, 10.0, 10.0)}
CSP_SIGN_MARGIN = 0.0          # the reference's sign scores above the other
CSP_CC_BAR = 0.5               # the average vs the reference, <= 60 Å
CSP_BATCH_TOL = 1e-2           # a renamed copy vs the single run (°, px)
CSP_BATCH_COPIES = 3


class _LogLines:
    """Collects the messages of one logger that contain `word`."""

    def __init__(self, logger_name, word):
        import logging

        outer = self
        self.lines = []

        class Handler(logging.Handler):
            def emit(self, record):
                msg = record.getMessage()
                if word in msg:
                    outer.lines.append(msg)

        self.handler = Handler()
        self.logger = logging.getLogger(logger_name)

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        return False


def _csp_layers_inputs():
    """The CSP schedule's inputs at csp_layers' shape on the card, on
    windows of noise: ((params, xv, window centres, defocus, mask points,
    Fref, tilt weights, validity), the generator that drew them)."""
    import torch

    from pyp_tpu_torch.ops import csp
    from pyp_tpu_torch.ops.fourier_slice import volume_to_fourier
    from pyp_tpu_torch.ops.refine3d import make_mask_points

    c = CSP_LAYERS
    S, T, P, n, pixel = c["S"], c["T"], c["P"], c["box"], c["pixel"]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.RandomState(0)
    mask = torch.as_tensor(make_mask_points(n, pixel, *c["band"]), device=dev)
    G = int(mask.shape[0])
    xv = torch.complex(torch.randn((S, T, P, G), generator=gen, device=dev),
                       torch.randn((S, T, P, G), generator=gen, device=dev))
    Fref = volume_to_fourier(torch.randn((n, n, n), generator=gen, device=dev))

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    params = csp.CspParams(
        f32(np.tile(np.linspace(-60, 60, T), (S, 1))), f32(np.zeros((S, T))),
        f32(np.zeros((S, T, 2))), f32(rng.uniform(0, 360, (S, P, 3))),
        f32(np.concatenate([rng.uniform(-100, 100, (S, P, 1)),
                            rng.uniform(-800, 800, (S, P, 2))], -1)),
        f32(np.zeros((S, T))))
    wc = torch.round(csp.project_positions(params))
    df = torch.full((S, T, 2), 20000.0, device=dev)
    tw = torch.ones((S, T), device=dev)
    valid = torch.ones((S, T, P), device=dev)
    return (params, xv, wc, df, mask, Fref, tw, valid), gen


def phase_csp_layers():
    """The CSP refinement alone at the reference bench's shape on windows of
    noise (no quality bar): the mode schedule plain and with the grid
    search, each with the series one after another and vectorized;
    the first call's wall (it captures the mode graphs at its shape) and
    projections per second of the next (S*T*P / wall), peak memory, one
    step's split
    into the reference gather, the NCC and the autograd backward; and
    accumulate_matrices of all S*T*P rows."""
    import torch

    from pyp_tpu_torch.ops import csp, kernels
    from pyp_tpu_torch.ops import reconstruct as rec

    c = CSP_LAYERS
    S, T, P, n, pixel = c["S"], c["T"], c["P"], c["box"], c["pixel"]
    args, gen = _csp_layers_inputs()
    params, xv, wc, df, mask, Fref, tw, valid = args
    dev = xv.device
    G = int(mask.shape[0])
    kernels.shift_scored_match.launches = 0
    row = {"phase": "csp_layers", "S": S, "T": T, "P": P, "box": n, "G": G,
           "modes": list(c["modes"]), "iters_per_mode": c["iters"]}
    for label, tols in (("plain", None), ("grid", CSP_LAYERS_GRID)):
        offs, spin = csp.build_mode_offsets(c["modes"], tols, 9)
        if tols:
            row["grid_candidates"] = {str(m): int(len(o)) for m, o in
                                      zip(c["modes"], offs) if o is not None}
        for vmap in (False, True):
            key = f"{label}_{'vectorized' if vmap else 'sequential'}"
            torch.cuda.reset_peak_memory_stats()
            # the first call at a shape captures its mode graphs; the
            # second replays them, as every later call does
            for when in ("first_", ""):
                out, wall = _sync_s(lambda: csp.csp_refine_batch(
                    *args, offs, spin, c["modes"], n, pixel,
                    iters_per_mode=c["iters"], series_vmap=vmap))
                row[f"{key}_{when}s"] = wall
            if not all(torch.isfinite(x).all() for x in out[0]):
                raise RuntimeError(f"csp_layers {key}: non-finite parameters")
            row[f"{key}_projections_per_s"] = S * T * P / wall
            row[f"{key}_max_memory_allocated_GiB"] = (
                torch.cuda.max_memory_allocated() / 2**30)
    # one gradient step of mode 1 (eulers) on the vectorized batch, split
    with torch.no_grad():
        df0 = csp._csp_df(params, df, pixel)
        u0 = csp._csp_model_gather(params, mask, Fref, n)
    row["gather_ms"] = _median_ms(
        lambda: csp._csp_model_gather(params, mask, Fref, n), reps=5)
    row["ncc_ms"] = _median_ms(lambda: csp._csp_ncc(
        params, xv, wc, df, mask, Fref, n, pixel, 300.0, 2.7, 0.07,
        u=u0, df=df0), reps=5)

    def step():
        e = params.particle_eulers.detach().requires_grad_(True)
        with torch.enable_grad():
            s = csp.csp_score(params._replace(particle_eulers=e), xv, wc, df,
                              mask, Fref, tw, valid, n, pixel,
                              xv_precomputed=True, df=df0)
            torch.autograd.grad(s.sum(), [e])

    row["step_ms"] = _median_ms(step, reps=5)
    row["autograd_ms"] = row["step_ms"] - row["gather_ms"] - row["ncc_ms"]
    # the reconstruction of every (series, tilt, particle) row
    R = csp.effective_rotations(params).reshape(-1, 3, 3)
    B = R.shape[0]
    wins = torch.randn((B, n, n), generator=gen, device=dev)
    zeros2 = torch.zeros((B, 2), device=dev)
    dfb = torch.full((B,), 20000.0, device=dev)
    sub = torch.arange(B, device=dev) % 2
    ones = torch.ones(B, device=dev)
    torch.cuda.reset_peak_memory_stats()
    row["accumulate_rows"] = B
    row["accumulate_matrices_ms"] = _median_ms(
        lambda: rec.accumulate_matrices(wins, R, zeros2, dfb, sub, ones, n,
                                        pixel), reps=3)
    row["accumulate_max_memory_allocated_GiB"] = (
        torch.cuda.max_memory_allocated() / 2**30)
    row["launches"] = kernels.shift_scored_match.launches
    emit(row)
    if row["launches"]:
        raise RuntimeError("csp_layers launched shift_scored_match")
    return row["launches"]


def phase_csp_gather():
    """The CSP model gather's kernel (ops.kernels.csp_slice_gather) at
    csp_layers' shape (8 x 41 x 128 rows x the band's mask points, Fref
    128^3 at box 64) against its plain version: forward max abs error,
    its share of bit-equal values and whether the zeros agree; the
    backward's relative L2 against autograd through the plain version for
    mode 0's and mode 1's blocks; medians of 11 CUDA-event launches of the
    forward and backward kernels beside the plain ones and the bytes
    bound; and the launches of one unit of the schedule (modes 3:0:2:1 x
    20, vectorized: 47 forward, 40 backward)."""
    import torch

    from pyp_tpu_torch.ops import csp, kernels

    c = CSP_LAYERS
    n = c["box"]
    args, gen = _csp_layers_inputs()
    params, xv, wc, df, mask, Fref, tw, valid = args
    scale = float(Fref.shape[0] // n)
    R = csp.effective_rotations(params)
    rows, G = R[..., 0, 0].numel(), int(mask.shape[0])
    row = {"phase": "csp_gather", "rows": rows, "G": G,
           "fref": list(Fref.shape)}
    with torch.no_grad():
        u = csp._csp_model_gather(params, mask, Fref, n)
        u0 = kernels.csp_slice_gather_plain(R, mask, Fref, scale)
    torch.cuda.synchronize()
    row.update(max_abs_u=float(u0.abs().max()),
               max_abs_err=float((u - u0).abs().max()),
               bit_equal_share=float(((u.real == u0.real)
                                      & (u.imag == u0.imag)).float().mean()),
               zeros_agree=bool(torch.equal(u == 0, u0 == 0)))
    del u, u0
    W = torch.complex(*(torch.randn(R.shape[:-2] + (G,), generator=gen,
                                    device=R.device) for _ in range(2)))
    for mode, blocks in ((0, ("tilt_angles", "axis_angles")),
                         (1, ("particle_eulers",))):
        grads = []
        for fn in (lambda p: csp._csp_model_gather(p, mask, Fref, n),
                   lambda p: kernels.csp_slice_gather_plain(
                       csp.effective_rotations(p), mask, Fref, scale)):
            leaves = {k: getattr(params, k).detach().requires_grad_(True)
                      for k in blocks}
            uu = fn(params._replace(**leaves))
            grads.append(torch.autograd.grad(
                uu, list(leaves.values()), W))
            del uu
        row[f"backward_rel_l2_mode{mode}"] = max(
            float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
            for a, b in zip(*grads))
    # kernel and plain times on fixed rotations (rows, 3, 3); gather_ms is
    # the whole call, effective_rotations included
    Rr = R.reshape(-1, 3, 3).detach().requires_grad_(True)
    Wf = W.reshape(rows, G)
    with torch.no_grad():
        row["kernel_ms"] = _median_ms(
            lambda: kernels.csp_slice_gather(Rr, mask, Fref, scale))
        row["gather_ms"] = _median_ms(
            lambda: csp._csp_model_gather(params, mask, Fref, n))
        row["plain_ms"] = _median_ms(
            lambda: kernels.csp_slice_gather_plain(Rr, mask, Fref, scale),
            reps=5)
    uk = kernels.csp_slice_gather(Rr, mask, Fref, scale)
    row["backward_kernel_ms"] = _median_ms(
        lambda: torch.autograd.grad(uk, Rr, Wf, retain_graph=True))
    del uk
    up = kernels.csp_slice_gather_plain(Rr, mask, Fref, scale)
    row["backward_plain_ms"] = _median_ms(
        lambda: torch.autograd.grad(up, Rr, Wf, retain_graph=True), reps=5)
    del up
    # the roofline's bytes: the output written once, Fref, the points and
    # the parameters read once (portbench/counts/csp_gather.py)
    nbytes = (8 * rows * G + 8 * Fref.numel() + 4 * mask.numel()
              + sum(4 * x.numel() for x in params))
    row["bound_ms"] = 1e3 * nbytes / HBM_BYTES_S
    row["kernel_share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
    # the launches of one unit of the schedule
    offs, spin = csp.build_mode_offsets(c["modes"], None, 9)
    f0 = kernels.csp_slice_gather.launches
    b0 = kernels.csp_slice_gather.backward_launches
    csp.csp_refine_batch(*args, offs, spin, c["modes"], n, c["pixel"],
                         iters_per_mode=c["iters"], series_vmap=True)
    torch.cuda.synchronize()
    row["unit_launches"] = kernels.csp_slice_gather.launches - f0
    row["unit_backward_launches"] = (kernels.csp_slice_gather.backward_launches
                                     - b0)
    row["ok"] = (row["max_abs_err"] <= 1e-5 * row["max_abs_u"]
                 and row["zeros_agree"]
                 and row["backward_rel_l2_mode0"] <= 1e-4
                 and row["backward_rel_l2_mode1"] <= 1e-4
                 and (row["unit_launches"], row["unit_backward_launches"])
                 == (47, 40))
    emit(row)
    if not row["ok"]:
        raise RuntimeError(f"csp_slice_gather disagrees with its plain "
                           f"version or launched other than 47 / 40 a unit: "
                           f"{row}")
    return row


def _device_ms(fn, names, reps=11):
    """Mean device ms of a launch of each kernel whose name holds one of
    `names`, over `reps` calls of fn after one more, from the profiler's
    CUDA activity (so the host's launch gaps are left out)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = []
    for name in names:
        evs = [e for e in prof.key_averages() if name in e.key]
        n = sum(e.count for e in evs)
        us = sum(getattr(e, "device_time_total", None) or e.cuda_time_total
                 for e in evs)
        out.append(us / n / 1e3 if n else None)
    return out


CSP_SCORE_KW = dict(voltage_kv=300.0, cs_mm=2.7, amplitude_contrast=0.07)


def _csp_score_cases():
    """The shapes the CSP score kernels serve, on the card: name -> (dshift,
    df, xv, u, mask, n, pixel). csp_layers' (the schedule's geometry on its
    noise windows), one series of the pipeline at box 256 (41 x 64 rows,
    the band's thousands of points), and a grid-search batch (9 candidate
    shifts of 2 x 41 x 128 rows, which read the windows and slice values
    once for all)."""
    import torch

    from pyp_tpu_torch.ops import csp
    from pyp_tpu_torch.ops.refine3d import make_mask_points

    c = CSP_LAYERS
    n, pixel = c["box"], c["pixel"]
    args, gen = _csp_layers_inputs()
    params, xv, wc, tdf, mask, Fref = args[:6]
    with torch.no_grad():
        cases = {"csp_layers": (
            csp.project_positions(params) - wc, csp._csp_df(params, tdf, pixel),
            xv, csp._csp_model_gather(params, mask, Fref, n), mask, n, pixel)}
    dev = xv.device

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    m256 = torch.as_tensor(make_mask_points(256, 2.0, *c["band"]), device=dev)
    G = int(m256.shape[0])
    cases["box256"] = (randn(41, 64, 2, scale=1.5),
                       15000.0 + randn(41, 64, scale=3000.0),
                       torch.complex(randn(41, 64, G), randn(41, 64, G)),
                       torch.complex(randn(41, 64, G), randn(41, 64, G)),
                       m256, 256, 2.0)
    d, f, x, u = (t[:2] for t in cases["csp_layers"][:4])
    cases["grid"] = (d + randn(9, 1, 1, 1, 2), f, x, u, mask, n, pixel)
    return cases


def phase_csp_score():
    """CSP's CTF-weighted NCC kernels (ops.kernels.csp_score,
    csrc/csp_score.cu) against the plain chain run in float64 on the card,
    at the shapes of `_csp_score_cases`: the forward's max abs error and
    the gradients' relative L2 (dshift, df, u), each beside the float32
    plain chain's own; the device ms of a forward, of a backward with and
    without u's gradient (profiler) beside the plain chain's (CUDA events)
    and the bytes bound (xv and u read once, du written once, at 3.35
    TB/s). Then one unit of the schedule at csp_layers' shape (modes
    3:0:2:1 x 20, vectorized) after the one that captures its graphs: 89
    forward and 80 backward launches, and no call of the plain chain on
    the card. Bars: error <= 1e-5, relative L2 <= 1e-4, neither more than
    twice the float32 chain's."""
    import torch

    from pyp_tpu_torch.ops import csp, kernels

    def grads(fn, ins, W):
        leaves = [x.detach().clone().requires_grad_(True) for x in ins]
        ncc = fn(*leaves)
        return ncc.detach(), torch.autograd.grad(torch.sum(W * ncc), leaves)

    def rel(a, b):
        return float(torch.linalg.vector_norm(a.to(b.dtype) - b)
                     / torch.linalg.vector_norm(b))

    row = {"phase": "csp_score"}
    ok = True
    for name, (ds, df, xv, u, mask, n, pixel) in _csp_score_cases().items():
        lead = torch.broadcast_shapes(ds.shape[:-1], df.shape, xv.shape[:-1],
                                      u.shape[:-1])
        W = torch.rand(lead, device=xv.device,
                       generator=torch.Generator(xv.device).manual_seed(1))

        def score(fn, dt=None):
            m, x = mask, xv
            if dt is not None:
                m, x = mask.to(dt), xv.to(torch.complex128)
            return lambda a, b, c: fn(a, b, x, c, m, n, pixel, **CSP_SCORE_KW)

        ins = (ds, df, u)
        got, g = grads(score(kernels.csp_score), ins, W)
        ref, g_ref = grads(score(kernels.csp_score_plain, torch.float64),
                           (ds.double(), df.double(),
                            u.to(torch.complex128)), W.double())
        p32, g_p32 = grads(score(kernels.csp_score_plain), ins, W)
        r = {"rows": int(W.numel()), "G": int(mask.shape[0]),
             "max_abs_err": float((got.double() - ref).abs().max()),
             "plain_f32_max_abs_err": float((p32.double() - ref).abs().max()),
             "grad_rel_l2": [rel(a, b) for a, b in zip(g, g_ref)],
             "plain_f32_grad_rel_l2": [rel(a, b) for a, b in zip(g_p32, g_ref)]}
        del ref, g_ref, p32, g_p32
        r["ok"] = (r["max_abs_err"] <= 1e-5
                   and r["max_abs_err"] <= 2 * r["plain_f32_max_abs_err"]
                   and all(e <= 1e-4 and e <= 2 * e32 for e, e32 in zip(
                       r["grad_rel_l2"], r["plain_f32_grad_rel_l2"])))
        ok = ok and r["ok"]
        # times: the kernels alone (profiler), the plain chain (events)
        leaves = [x.detach().clone().requires_grad_(True) for x in ins]
        with torch.no_grad():
            r["forward_ms"], = _device_ms(
                lambda: kernels.csp_score(ds, df, xv, u, mask, n, pixel,
                                          **CSP_SCORE_KW), ("score_forward",))
        out = kernels.csp_score(*leaves[:2], xv, leaves[2], mask, n, pixel,
                                **CSP_SCORE_KW)
        r["backward_du_ms"], = _device_ms(lambda: torch.autograd.grad(
            out, leaves, W, retain_graph=True), ("score_backward",))
        r["backward_ms"], = _device_ms(lambda: torch.autograd.grad(
            out, leaves[:2], W, retain_graph=True), ("score_backward",))
        del out
        with torch.no_grad():
            r["plain_forward_ms"] = _median_ms(lambda: kernels.csp_score_plain(
                ds, df, xv, u, mask, n, pixel, **CSP_SCORE_KW), reps=5)
        out = kernels.csp_score_plain(*leaves[:2], xv, leaves[2], mask, n,
                                      pixel, **CSP_SCORE_KW)
        r["plain_backward_ms"] = _median_ms(lambda: torch.autograd.grad(
            out, leaves, W, retain_graph=True), reps=5)
        del out, leaves
        # bytes: xv and u read once (a row that every candidate reads
        # counted once) and 16 a row (the forward writes ncc and the sums,
        # the backward reads the sums and writes three gradients), and
        # with u's gradient du written once
        nbytes = 8 * (xv.numel() + u.numel()) + 16 * W.numel()
        r["bound_ms"] = 1e3 * nbytes / HBM_BYTES_S
        r["backward_du_bound_ms"] = 1e3 * (nbytes + 8 * W.numel()
                                           * mask.shape[0]) / HBM_BYTES_S
        r["forward_share_of_bound"] = r["bound_ms"] / r["forward_ms"]
        row[name] = r
    # one unit of the schedule after the one that captures its graphs
    c = CSP_LAYERS
    args, _ = _csp_layers_inputs()
    offs, spin = csp.build_mode_offsets(c["modes"], None, 9)
    plain_calls = []
    plain = kernels.csp_score_plain

    def counted_plain(dshift, *a, **kw):
        plain_calls.append(dshift.device.type)
        return plain(dshift, *a, **kw)

    csp.graph.clear()
    kernels.csp_score_plain = counted_plain
    try:
        for _ in range(2):
            f0 = kernels.csp_score.launches
            b0 = kernels.csp_score.backward_launches
            csp.csp_refine_batch(*args, offs, spin, c["modes"], c["box"],
                                 c["pixel"], iters_per_mode=c["iters"],
                                 series_vmap=True)
            torch.cuda.synchronize()
    finally:
        kernels.csp_score_plain = plain
    row["unit_launches"] = kernels.csp_score.launches - f0
    row["unit_backward_launches"] = kernels.csp_score.backward_launches - b0
    row["plain_calls_on_the_card"] = plain_calls.count("cuda")
    row["ok"] = ok and (row["unit_launches"], row["unit_backward_launches"],
                        row["plain_calls_on_the_card"]) == (89, 80, 0)
    emit(row)
    if not row["ok"]:
        raise RuntimeError(f"csp_score disagrees with its plain version, or "
                           f"launched other than 89 / 80 a unit: {row}")
    return row


def _insert_scatter_inputs(gen, uniform=False):
    """The insertion's scatter inputs at csp_layers' shape on the card:
    (q, vals, c2, set_id, pn, nxf, n_sets) of S*T*P central slices (box n,
    pad 2; n x n//2+1 samples a row) at random rotations, halves by
    particle, random values and CTF^2 weights. With `uniform`, the same
    samples at points drawn uniformly in the padded Nyquist ball, which
    no two rows share more than by chance (no hot origin)."""
    import torch

    from pyp_tpu_torch.core.geometry import euler_to_matrix
    from pyp_tpu_torch.ops.fourier_slice import slice_coords

    c = CSP_LAYERS
    B, n, pn = c["S"] * c["T"] * c["P"], c["box"], 2 * c["box"]
    dev = torch.device("cuda")
    ang = torch.rand((3, B), generator=gen, device=dev) * 360.0
    q = slice_coords(euler_to_matrix(*ang), n) * 2.0
    if uniform:
        d = torch.randn(q.shape, generator=gen, device=dev)
        r = torch.rand(q.shape[:-1] + (1,), generator=gen, device=dev)
        q = (d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
             * (pn // 2) * r ** (1.0 / 3.0)).contiguous()
    shape = q.shape[:-1]
    vals = torch.complex(torch.randn(shape, generator=gen, device=dev),
                         torch.randn(shape, generator=gen, device=dev))
    c2 = torch.rand(shape, generator=gen, device=dev)
    set_id = (torch.arange(B, device=dev) % c["P"]) % 2
    return q, vals, c2, set_id, pn, pn // 2 + 1, 2


def _counted_corners(q, pn, nxf, rows=4096):
    """(samples inside the sphere, corners the kernel adds: inside, kx <=
    nxf - 1 and a nonzero weight), the plain chain's rules, in row
    chunks."""
    import torch

    inside = corners = 0
    for q_ in q.split(rows):
        flip = q_[..., 2] < 0
        qs = torch.where(flip[..., None], -q_, q_)
        k0 = torch.floor(qs)
        frac = qs - k0
        ins = torch.sum(q_ * q_, dim=-1) <= (pn // 2) ** 2
        inside += int(ins.sum())
        for c in range(8):
            d = (c >> 2, (c >> 1) & 1, c & 1)
            w = ((frac[..., 0] if d[0] else 1 - frac[..., 0])
                 * (frac[..., 1] if d[1] else 1 - frac[..., 1])
                 * (frac[..., 2] if d[2] else 1 - frac[..., 2]))
            kx = k0[..., 2] + d[2]
            corners += int((ins & (kx <= nxf - 1) & (w != 0)).sum())
    return inside, corners


def phase_insert_scatter():
    """The insertion's scatter kernel (ops.kernels.insert_scatter,
    csrc/insert_scatter.cu) at the csp_modes shape (41,984 rows of 64 x 33
    samples, pn 128, two sets): its device ms (profiler, mean of 11
    launches) beside the bytes bound (24 B a sample at 3.35 TB/s) and the
    count of corner atomics; the same samples at points drawn uniformly in
    the ball (the origin's contention left out); the wrapper's wall and
    the plain chain's (CUDA events); the max abs error of kernel and plain
    chain against the plain chain in float64 (row chunks); then
    `insert_scatter.launches` over one accumulate_matrices of the unit's
    rows, which should read 1. Bars, 2 wavenumbers inside the Nyquist
    sphere: the kernel's error within 1e-5 of each accumulator's max and
    no more than twice the float32 chain's plus 1e-6 of that max, the
    kernel within 1e-5 of that max of the float32 chain everywhere
    (atomic order), 1 launch a unit."""
    import torch

    from pyp_tpu_torch.ops import kernels
    from pyp_tpu_torch.ops import reconstruct as rec

    gen = torch.Generator(device="cuda").manual_seed(20)
    args = _insert_scatter_inputs(gen)
    q, vals, c2, set_id, pn, nxf, n_sets = args
    samples = vals.numel()
    row = {"phase": "insert_scatter", "rows": int(q.shape[0]),
           "samples": samples, "pn": pn, "n_sets": n_sets}
    with torch.no_grad():
        row["kernel_ms"], row["split_ms"] = _device_ms(
            lambda: kernels.insert_scatter(*args), ("scatter", "split"))
        row["wrapper_ms"] = _median_ms(lambda: kernels.insert_scatter(*args))
        row["inside"], row["corner_atomics"] = _counted_corners(q, pn, nxf)
        row["bound_ms"] = 1e3 * 24 * samples / HBM_BYTES_S
        row["kernel_share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
        row["atomics_per_ns"] = row["corner_atomics"] / (row["kernel_ms"] * 1e6)
        got = kernels.insert_scatter(*args)
        p32 = kernels.insert_scatter_plain(*args)
        torch.cuda.reset_peak_memory_stats()
        row["plain_ms"] = _median_ms(
            lambda: kernels.insert_scatter_plain(*args), reps=3)
        row["plain_peak_GiB"] = torch.cuda.max_memory_allocated() / 2**30
        ref = None
        for sl in zip(*(x.split(4096) for x in args[:4])):
            part = kernels.insert_scatter_plain(
                sl[0].double(), sl[1].to(torch.complex128), sl[2].double(),
                sl[3], pn, nxf, n_sets)
            ref = part if ref is None else tuple(a + b for a, b in zip(ref, part))
        # a sample within a last bit of the Nyquist sphere is kept or
        # dropped by its float32 r^2 (kernel and chain alike) and not by
        # the float64 one: whole terms differ there, so the bars read the
        # voxels 2 wavenumbers inside it (as the benchmark's acc_rel_err)
        kz = torch.fft.fftfreq(pn, 1.0 / pn, device=q.device)
        kx = torch.arange(nxf, device=q.device, dtype=kz.dtype)
        r = torch.sqrt(kz[:, None, None] ** 2 + kz[None, :, None] ** 2
                       + kx[None, None, :] ** 2)
        inner = r <= pn // 2 - 2
        errs, ok = {}, True
        for name, a, a32, b in (("num", got[0], p32[0], ref[0]),
                                ("den", got[1], p32[1], ref[1])):
            top = float(b.abs().max())
            d, d32 = ((x.to(b.dtype) - b).abs() for x in (a, a32))
            e, e32 = float(d[:, inner].max()), float(d32[:, inner].max())
            errs[name] = {"max": top, "max_abs_err": e,
                          "plain_f32_max_abs_err": e32,
                          "edge_max_abs_err": float(d.max()),
                          "plain_f32_edge_max_abs_err": float(d32.max()),
                          "kernel_vs_plain_f32": float((a - a32).abs().max())}
            ok = (ok and e <= 1e-5 * top and e <= 2 * e32 + 1e-6 * top
                  and errs[name]["kernel_vs_plain_f32"] <= 1e-5 * top)
        del d, d32, inner, r
        row["errors"] = errs
        del got, p32, ref
        uni = _insert_scatter_inputs(gen, uniform=True)
        row["uniform_kernel_ms"], = _device_ms(
            lambda: kernels.insert_scatter(*uni), ("scatter",))
        row["uniform_inside"], row["uniform_corner_atomics"] = _counted_corners(
            uni[0], pn, nxf)
        del uni, args, q, vals, c2
    # one accumulate_matrices of the unit's rows, as csp_layers runs it
    c = CSP_LAYERS
    n, B = c["box"], row["rows"]
    wins = torch.randn((B, n, n), generator=gen, device="cuda")
    R = torch.linalg.qr(torch.randn((B, 3, 3), generator=gen, device="cuda"))[0]
    zeros2 = torch.zeros((B, 2), device="cuda")
    dfb = torch.full((B,), 20000.0, device="cuda")
    sub = set_id
    ones = torch.ones(B, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    l0 = kernels.insert_scatter.launches
    rec.accumulate_matrices(wins, R, zeros2, dfb, sub, ones, n, c["pixel"])
    torch.cuda.synchronize()
    row["unit_launches"] = kernels.insert_scatter.launches - l0
    row["accumulate_max_memory_allocated_GiB"] = (
        torch.cuda.max_memory_allocated() / 2**30)
    row["accumulate_matrices_ms"] = _median_ms(
        lambda: rec.accumulate_matrices(wins, R, zeros2, dfb, sub, ones, n,
                                        c["pixel"]), reps=3)
    row["ok"] = ok and row["unit_launches"] == 1
    emit(row)
    if not row["ok"]:
        raise RuntimeError(f"insert_scatter disagrees with the float64 chain "
                           f"or launched other than once a unit: {row}")
    return row


class _EagerSteps:
    """Stands in for ops.csp.graph: each mode's steps run eagerly."""

    def run(self, h, b):
        from pyp_tpu_torch.ops import csp

        return csp._eager_steps(b, h)


def _differ(a, b):
    """(share of values that differ, largest absolute difference) of two
    lists of tensors."""
    n = sum(x.numel() for x in a)
    neq = sum(int((x != y).sum()) for x, y in zip(a, b))
    return neq / n, max(float((x - y).abs().max()) for x, y in zip(a, b))


def _within(d, bound):
    """Whether the (share, largest difference) d is no wider than bound's
    in both."""
    return d[0] <= bound[0] and d[1] <= bound[1]


def phase_csp_graph():
    """The CSP step loops as CUDA graphs (ops.csp.ModeGraphs) at
    csp_layers' shape, each mode of 3:0:2:1 at 20 steps: a fresh cache's
    result at the first call (two warm-up steps, the capture and a replay)
    and at two more replays, the first with other inputs, each against the
    eager step function
    (`ops.csp._mode_steps`) on the same inputs, bit for bit; the
    synchronised wall ms of the eager loop, the first call and a replay;
    the gather's and the score's launches a replay adds to the kernels'
    counters against the kernels the profiler sees run in a replay; the
    memory the
    captures reserve. Then three calls of csp_refine_batch (vectorized,
    the process's own cache, which replays from the second call on at the
    latest) against the same schedule with eager steps, parameters and
    scores bit for bit. Where the graph differs, the eager loop run twice
    shows whether the eager loop itself is reproducible: the graph may
    then differ by no more than two eager runs do."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pyp_tpu_torch.ops import csp, kernels

    c = CSP_LAYERS
    n, pixel = c["box"], c["pixel"]
    args, gen = _csp_layers_inputs()
    params = args[0]
    other = params._replace(
        tilt_shifts=params.tilt_shifts + torch.randn(
            params.tilt_shifts.shape, generator=gen, device=gen.device),
        particle_eulers=params.particle_eulers + torch.randn(
            params.particle_eulers.shape, generator=gen, device=gen.device))

    def counters():     # the gather's and the score's, forward and backward
        return tuple(getattr(fn, k) for fn in (kernels.csp_slice_gather,
                                               kernels.csp_score)
                     for k in ("launches", "backward_launches"))

    graphs = csp.ModeGraphs()
    eager = _EagerSteps()
    row = {"phase": "csp_graph", "modes": list(c["modes"]),
           "iters": c["iters"]}
    ok = True
    for mode in c["modes"]:
        h = csp._Steps(mode, n, pixel, c["iters"], 0.3, 0.1, 300.0, 2.7,
                       0.07, 0.0, 0.0)
        with torch.no_grad():
            b1 = csp._mode_buffers(*args, h)
            b2 = csp._mode_buffers(other, *args[1:], h)
        want1, eager_s = _sync_s(lambda: eager.run(h, b1))
        want2 = eager.run(h, b2)
        reserved = torch.cuda.memory_reserved()
        got1, first_s = _sync_s(lambda: graphs.run(h, b1))
        reserved = torch.cuda.memory_reserved() - reserved
        f0 = counters()
        got2, replay_s = _sync_s(lambda: graphs.run(h, b2))
        launches = tuple(a - b for a, b in zip(counters(), f0))
        f0 = counters()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            got3 = graphs.run(h, b1)
            torch.cuda.synchronize()
        counted = tuple(a - b for a, b in zip(counters(), f0))
        ran = tuple(sum(e.count for e in prof.key_averages() if name in e.key)
                    for name in ("slice_gather_forward",
                                 "slice_gather_backward", "score_forward",
                                 "score_backward"))
        ok = ok and counted == ran == launches
        blocks = csp.MODE_BLOCKS[mode]
        equal = all(torch.equal(g[k], w[k]) for g, w in
                    ((got1, want1), (got2, want2), (got3, want1))
                    for k in blocks)
        r = {"eager_ms": 1e3 * eager_s, "first_call_ms": 1e3 * first_s,
             "replay_ms": 1e3 * replay_s, "replay_launches": launches,
             "profiled_replay_kernels": ran,
             "reserved_by_capture_GiB": reserved / 2**30,
             "bit_equal": equal}
        if not equal:
            again = eager.run(h, b2)
            r["graph_vs_eager"] = _differ([got2[k] for k in blocks],
                                          [want2[k] for k in blocks])
            r["eager_vs_eager"] = _differ([again[k] for k in blocks],
                                          [want2[k] for k in blocks])
            ok = ok and _within(r["graph_vs_eager"], r["eager_vs_eager"])
        row[f"mode{mode}"] = r
    row["captures"], row["replays"] = graphs.captures, graphs.replays
    graphs.clear()
    # the whole schedule: the process's cache (which replays from the
    # second call at the latest) against eager steps
    offs, spin = csp.build_mode_offsets(c["modes"], None, 9)

    def refine():
        return csp.csp_refine_batch(*args, offs, spin, c["modes"], n, pixel,
                                    iters_per_mode=c["iters"],
                                    series_vmap=True)

    def flat(out):
        return list(out[0]) + list(out[1:])

    r0 = csp.graph.replays
    with_graphs = [flat(refine()) for _ in range(3)]
    row["schedule_replays"] = csp.graph.replays - r0
    cache = csp.graph
    csp.graph = eager
    try:
        plain = flat(refine())
        torch.cuda.synchronize()
        equal = [all(torch.equal(a, b) for a, b in zip(o, plain))
                 for o in with_graphs]
        row["schedule_bit_equal"] = all(equal)
        if not all(equal):
            again = flat(refine())
            diffs = [_differ(o, plain) for o, e in zip(with_graphs, equal)
                     if not e]
            row["schedule_differ"] = tuple(map(max, zip(*diffs)))
            row["schedule_eager_vs_eager"] = _differ(again, plain)
    finally:
        csp.graph = cache
    # bit for bit, or no wider apart than two eager schedules
    row["ok"] = ok and row["schedule_replays"] >= 2 * len(c["modes"]) and (
        row["schedule_bit_equal"]
        or _within(row["schedule_differ"], row["schedule_eager_vs_eager"]))
    emit(row)
    if not row["ok"]:
        raise RuntimeError(f"the CSP step graphs disagree with the eager "
                           f"steps: {row}")
    return row


def _matched_picks(base, truth, thickness):
    """The tomo project's picks as the csp mode centres them (unbinned
    px), and one per planted particle (tools/e2e_csp.matched_picks):
    (all picks, kept pick indices, their planted indices)."""
    from pyp_tpu_torch.tools import e2e_csp

    meta = _tomo_meta(base)
    picks = e2e_csp.pick_positions(meta["box"], meta.scalars["binning"],
                                   thickness, truth["size"])
    keep, idx = e2e_csp.matched_picks(picks, truth, truth["pixel"])
    return picks, keep, idx


def _csp_project(base, root, name, truth, eulers, box, ref, pixel, keep,
                 copies=()):
    """A copy of the tomo project for one CSP run: its bundle's picks cut
    to `keep` (tools/e2e_csp.matched_picks), the reference map, the start
    table, and for `copies` the bundle renamed."""
    import shutil

    from pyp_tpu_torch.io import mrc
    from pyp_tpu_torch.io.metadata import ItemMetadata
    from pyp_tpu_torch.tools import e2e_csp

    proj = os.path.join(root, name)
    shutil.copytree(base, proj, ignore=shutil.ignore_patterns("*.rec.mrc",
                                                              "*.png"))
    meta = ItemMetadata("ts01", proj, mode="tomo").load()
    meta["box"] = meta["box"][keep]
    meta.save()
    mrc.write(ref.astype(np.float32), os.path.join(proj, "initial_model.mrc"),
              pixel_size=pixel)
    os.makedirs(os.path.join(proj, "start"))
    for series in ("ts01",) + tuple(copies):
        e2e_csp.write_start(os.path.join(proj, "start", f"{series}.cistem"),
                            eulers)
        if series != "ts01":
            for ext in (".meta.npz", ".meta.json"):
                shutil.copy(os.path.join(proj, "ts01" + ext),
                            os.path.join(proj, series + ext))
    return proj


def _csp_read(proj, series, truth, rotations, sign, pixel):
    """The run's readings for one series: orientation errors from the
    ArtiaX star's angles, per-tilt shift errors from the refined xf."""
    from pyp_tpu_torch.io.metadata import ItemMetadata
    from pyp_tpu_torch.tools import e2e_csp, e2e_tomo

    rows = [ln.split("\t") for ln in open(os.path.join(
        proj, "artiax", f"{series}_K1.star")).read().splitlines()
            if ln.startswith(series + "\t")]
    eulers = np.array([[float(v) for v in r[4:7]] for r in rows])
    meta = ItemMetadata(series, proj, mode="tomo").load()
    return dict(
        eulers=eulers,
        orientation_err=e2e_csp.orientation_errors_deg(eulers, rotations),
        shift_err=e2e_tomo.shift_errors_px(meta["xf"], truth, pixel, sign),
        xf=meta["xf"], scores=meta["csp_scores"])


def phase_csp(data_dir, root, tt, base, box=None, band=None,
              thickness=2048, extra=()):
    """`csp` through cli.main on copies of the tomo phase's project (41 x
    4096² at 1 Å/px, the port's own picks), started from tools/e2e_csp:
    the reference's sign against the other; the default schedule from
    START_ERROR_DEG, then resumed; -csp_GridSearch from
    GRID_START_ERROR_DEG; and a batch of renamed copies of the series,
    each held to the single run. Bars, each predicted in PERF.md first:
    orientation error below the start's, per-tilt shift error no worse
    than the bundle's, the average's cc with the reference above
    CSP_CC_BAR, the resumed call under RESUME_BAR of the first. Returns
    the kernel launches of the runs."""
    import torch

    from pyp_tpu_torch.io import mrc
    from pyp_tpu_torch.ops import csp, kernels
    from pyp_tpu_torch.pipeline import csp as csp_pipe
    from pyp_tpu_torch.tools import e2e_csp, e2e_tomo

    truth = tt.truth
    pixel, size = truth["pixel"], truth["size"]
    box = box or e2e_csp.CSP_BOX
    band = band or e2e_csp.CSP_BAND
    meta0 = _tomo_meta(base)
    sign = float(meta0.scalars["xf_shift_sign"])
    all_picks, keep, idx = _matched_picks(base, truth, thickness)
    picks = all_picks[keep]
    rotations = e2e_csp.planted_rotations(truth)[idx]
    ref = e2e_csp.reference(truth, box, pixel)
    start = e2e_csp.start_eulers(rotations, e2e_csp.START_ERROR_DEG, seed=1)
    failures = []
    row = {"phase": "csp", "box": box, "band_A": list(band),
           "picks_all": int(len(all_picks)), "picks": int(len(picks)),
           "pick_offset_in_tilts_median_px": float(np.median(
               e2e_csp.projected_offsets(picks, meta0["xf"], meta0["tlt"],
                                         sign, truth, size))),
           "shift_err_bundle_median_px": float(np.median(
               e2e_tomo.shift_errors_px(meta0["xf"], truth, pixel, sign))),
           "start_error_deg": e2e_csp.START_ERROR_DEG}

    # the reference's sign: the start's score against the negated map's
    tilts = torch.as_tensor(mrc.read(os.path.join(data_dir, "ts01.mrc")),
                            device="cuda").float()
    cp = csp_pipe.series_params_from_metadata(meta0, picks, start)
    for key, r in (("score_reference", ref), ("score_negated", -ref)):
        row[key] = csp.csp_refine(cp, tilts, meta0["ctf"][:, :2], r, pixel,
                                  box, modes=(3,), iters_per_mode=0,
                                  low_res=band[0], high_res=band[1],
                                  reg_weight=0.0)[1][0]
    del tilts
    if not row["score_reference"] > row["score_negated"] + CSP_SIGN_MARGIN:
        failures.append("the negated reference scores higher")

    argv = ["csp", "-scope_pixel", str(pixel), "-scope_voltage", "300",
            "-scope_cs", "2.7", "-scope_wgh", "0.07", "-csp_box", str(box),
            "-csp_rlref", str(band[0]), "-csp_rhref", str(band[1]),
            "-csp_transreg", "0", "-tomo_rec_thickness", str(thickness),
            "-csp_parfile", "start", "-no_plot_per_item"] + list(extra)
    one = ["-data_path", os.path.join(data_dir, "ts01.mrc")]
    kernels.shift_scored_match.launches = 0

    # the default schedule (3:0:2:1, 20 steps a mode), then resumed
    proj = _csp_project(base, root, "csp", truth, start, box, ref, pixel,
                        keep)
    torch.cuda.reset_peak_memory_stats()
    with _StageTimes() as stages:
        summary, wall = _cli_json(argv + one, proj)
    res = _csp_read(proj, "ts01", truth, rotations, sign, pixel)
    avg = mrc.read(os.path.join(proj, "maps", "dataset_csp_02.mrc"))
    row.update(
        seconds=wall, stages_s=dict(stages.rows),
        max_memory_allocated_GiB=torch.cuda.max_memory_allocated() / 2**30,
        fsc143_A=summary["resolution"],
        orientation_err_median_deg=float(np.median(res["orientation_err"])),
        shift_err_median_px=float(np.median(res["shift_err"])),
        average_cc=e2e_csp.map_cc(avg, ref, pixel, band[1]),
        average_cc_negated=e2e_csp.map_cc(avg, -ref, pixel, band[1]),
        score_mean=float(np.mean(res["scores"])))
    if not row["orientation_err_median_deg"] < e2e_csp.START_ERROR_DEG:
        failures.append(f"csp: orientation error "
                        f"{row['orientation_err_median_deg']:.3f}°")
    if not row["shift_err_median_px"] <= row["shift_err_bundle_median_px"]:
        failures.append(f"csp: shift error {row['shift_err_median_px']:.3f} "
                        f"px above the bundle's")
    if not (row["average_cc"] > CSP_CC_BAR and np.isfinite(avg).all()):
        failures.append(f"csp: average cc {row['average_cc']:.4f}")
    with _StageTimes() as again:
        summary2, wall2 = _cli_json(argv + one + ["-csp_resume"], proj)
    row.update(resume_seconds=wall2, resume_stages_run=len(again.rows))
    if not (summary2.get("resumed") and wall2 < RESUME_BAR * wall):
        failures.append(f"csp: the resumed call took {wall2:.2f} s of "
                        f"{wall:.2f} s ({summary2})")

    # the grid search from a wider start
    start_g = e2e_csp.start_eulers(rotations, e2e_csp.GRID_START_ERROR_DEG,
                                   seed=2)
    proj_g = _csp_project(base, root, "csp_grid", truth, start_g, box, ref,
                          pixel, keep)
    summary_g, wall_g = _cli_json(argv + one + [
        "-csp_GridSearch", "-csp_ToleranceMicrographTiltAngles", "2",
        "-csp_ToleranceMicrographShifts", "10",
        "-csp_ToleranceParticlesShifts", "10"], proj_g)
    res_g = _csp_read(proj_g, "ts01", truth, rotations, sign, pixel)
    row.update(grid_seconds=wall_g, grid_fsc143_A=summary_g["resolution"],
               grid_start_error_deg=e2e_csp.GRID_START_ERROR_DEG,
               grid_orientation_err_median_deg=float(
                   np.median(res_g["orientation_err"])),
               grid_shift_err_median_px=float(np.median(res_g["shift_err"])))
    if not (row["grid_orientation_err_median_deg"]
            < e2e_csp.GRID_START_ERROR_DEG):
        failures.append(f"csp_grid: orientation error "
                        f"{row['grid_orientation_err_median_deg']:.3f}°")

    # renamed copies refined together (csp_swarm_batch, vectorized)
    names = [f"ts{k:02d}" for k in range(2, 2 + CSP_BATCH_COPIES)]
    proj_b = _csp_project(base, root, "csp_batch", truth, start, box, ref,
                          pixel, keep, copies=names)
    series_dir = os.path.join(proj_b, "series")
    os.makedirs(series_dir)
    for series in ["ts01"] + names:
        os.symlink(os.path.join(data_dir, "ts01.mrc"),
                   os.path.join(series_dir, f"{series}.mrc"))
    torch.cuda.reset_peak_memory_stats()
    summary_b, wall_b = _cli_json(argv + [
        "-data_path", os.path.join(series_dir, "ts*.mrc")], proj_b)
    diffs = []
    for series in ["ts01"] + names:
        rb = _csp_read(proj_b, series, truth, rotations, sign, pixel)
        diffs.append(max(float(np.abs(rb["eulers"] - res["eulers"]).max()),
                         float(np.abs(rb["xf"] - res["xf"]).max())))
    row.update(batch_series=1 + len(names), batch_seconds=wall_b,
               batch_max_memory_allocated_GiB=(
                   torch.cuda.max_memory_allocated() / 2**30),
               batch_fsc143_A=summary_b["resolution"],
               batch_max_diff_to_single=max(diffs),
               launches=kernels.shift_scored_match.launches)
    if not max(diffs) <= CSP_BATCH_TOL:
        failures.append(f"csp_batch: a copy differs by {max(diffs):.4g}")
    emit(row)
    if row["launches"]:
        failures.append("csp launched shift_scored_match")
    if failures:
        raise RuntimeError("csp bars failed: " + "; ".join(failures))
    return row["launches"]


SVA_BOX = 48
SVA_CC_BAR = 0.5               # the average vs the particle map, aligned


def phase_sva(root, tt, base, box=SVA_BOX, rec_pixel=TOMO_REC_PIXEL,
              thickness=2048):
    """`sva` through cli.main on copies of the csp_tomo project (the
    rec-bin-8 tomogram and its 3D picks, cut to one per planted particle
    as for csp): reference-free, with -sva_ref (the particle map at the
    rec pixel; the tomogram shows the particles bright, so the map is not
    negated), and with -sva_classes 2. Bar: each average's cc with the
    particle map after align_volumes above SVA_CC_BAR. Returns the kernel
    launches."""
    import shutil

    import torch

    from pyp_tpu_torch.io import mrc
    from pyp_tpu_torch.io.metadata import ItemMetadata
    from pyp_tpu_torch.ops import kernels
    from pyp_tpu_torch.ops.template_match import align_volumes
    from pyp_tpu_torch.tools import e2e_tomo

    truth_map = e2e_tomo.particle_map(tt.truth, box, rec_pixel).cpu().numpy()
    _, keep, _ = _matched_picks(base, tt.truth, thickness)
    kernels.shift_scored_match.launches = 0
    row = {"phase": "sva", "box": box, "rec_pixel_A": rec_pixel}
    failures = []
    for label, extra in (("free", []), ("ref", ["-sva_ref", "ref.mrc"]),
                         ("classes", ["-sva_classes", "2"])):
        proj = os.path.join(root, f"sva_{label}")
        shutil.copytree(base, proj, ignore=shutil.ignore_patterns("*.png"))
        meta = ItemMetadata("ts01", proj, mode="tomo").load()
        meta["box"] = meta["box"][keep]
        meta.save()
        mrc.write(truth_map, os.path.join(proj, "ref.mrc"),
                  pixel_size=rec_pixel)
        torch.cuda.reset_peak_memory_stats()
        with _StageTimes() as stages:
            out, wall = _cli_json(["sva", "-scope_pixel", str(tt.truth["pixel"]),
                                   "-sva_box", str(box)] + extra, proj)
        avg = mrc.read(os.path.join(proj, "dataset_sva.mrc"))
        cc = float(align_volumes(avg, truth_map, device="cuda")[0])
        row.update({f"{label}_seconds": wall,
                    f"{label}_stages_s": dict(stages.rows),
                    f"{label}_max_memory_allocated_GiB":
                        torch.cuda.max_memory_allocated() / 2**30,
                    f"{label}_subvolumes": out["subvolumes"],
                    f"{label}_mean_score": out["mean_score"],
                    f"{label}_aligned_cc": cc})
        if label == "classes":
            row["classes"] = out["classes"]
        if not (cc > SVA_CC_BAR and np.isfinite(avg).all()):
            failures.append(f"sva {label}: aligned cc {cc:.4f}")
    row["launches"] = kernels.shift_scored_match.launches
    emit(row)
    if row["launches"]:
        failures.append("sva launched shift_scored_match")
    if failures:
        raise RuntimeError("sva bars failed: " + "; ".join(failures))
    return row["launches"]


def phase_polish(project, refined, movies_dir, fsc_unpolished, volume):
    """`polish` through cli.main on the spr_refine run that refines (the
    micrograph's contrast, -no_extract_inv so the polished stack keeps it):
    the three movies' particles re-extracted from their 40 frames along the
    bundles' drift, trajectories refined against the FRM map; then the FRM
    protocol again on the polished stack. Reports seconds per micrograph
    and the trajectory RMS (the movies carry only the global drift, so near
    0). Bar: the polished stack's FSC(0.143) within one shell of the
    unpolished one's. Returns the kernel launches of the polish call."""
    import glob
    import shutil

    import torch

    from pyp_tpu_torch.io import mrc
    from pyp_tpu_torch.ops import kernels
    from pyp_tpu_torch.tools import e2e_spa, e2e_spr, profile_refine
    from pyp_tpu_torch.tools.e2e_spa import FRM_ARGS, SLICE

    work = os.path.join(os.path.dirname(refined), "polish")
    shutil.copytree(refined, work)
    for path in glob.glob(os.path.join(project, "*.meta.*")):
        shutil.copy(path, work)
    maps = sorted(glob.glob(os.path.join(work, "maps", "dataset_r01_??.cistem")))
    shutil.copy(maps[-1], os.path.join(work, "stack.cistem"))
    kernels.shift_scored_match.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with _StageTimes() as stages, _LogLines("pyp_tpu_torch.cli",
                                            "trajectory RMS") as rms:
        out, wall = _cli_json(
            ["polish", "-data_path", os.path.join(movies_dir, "*.mrc"),
             "-scope_pixel", str(SLICE["pixel"]), "-extract_box",
             str(SLICE["box"]), "-no_extract_inv", "-no_plot_per_item"], work)
    launches = kernels.shift_scored_match.launches
    per_movie = [s for name, s in stages.rows if name.startswith("polish ")]
    traj_rms = [float(ln.rsplit(" ", 2)[-2]) for ln in rms.lines]
    row = {"phase": "polish", "seconds": wall, "polished": out["polished"],
           "seconds_per_micrograph": per_movie,
           "max_memory_allocated_GiB": torch.cuda.max_memory_allocated() / 2**30,
           "trajectory_rms_px": traj_rms, "launches": launches}
    # the FRM protocol again, from the same start, on the polished stack
    truth = e2e_spr.with_envelope(volume, e2e_spr.MOVIES["envelope"])
    init = e2e_spa.starting_map(truth, SLICE["pixel"], e2e_spa.START_RESOLUTION)
    refine_dir = os.path.join(os.path.dirname(refined), "polish_refine")
    os.makedirs(refine_dir)
    shutil.copy(os.path.join(project, "stack.cistem"), refine_dir)
    shutil.copy(os.path.join(work, "stack.mrc"), refine_dir)
    mrc.write(init, os.path.join(refine_dir, "initial_model.mrc"),
              pixel_size=SLICE["pixel"])
    cwd = os.getcwd()
    os.chdir(refine_dir)
    try:
        iters, wall_r = _sync_s(lambda: profile_refine.drive(FRM_ARGS, "cuda"))
    finally:
        os.chdir(cwd)
    fsc = iters[max(iters)]["fsc143_A"]
    shell = fsc_unpolished ** 2 / (SLICE["box"] * SLICE["pixel"])
    row.update(refine_seconds=wall_r, fsc143_A=fsc,
               fsc143_unpolished_A=fsc_unpolished, one_shell_A=shell)
    emit(row)
    if launches:
        raise RuntimeError("polish launched shift_scored_match")
    if not (out["polished"] == len(mrc.read(os.path.join(work, "stack.mrc")))
            and fsc <= fsc_unpolished + shell):
        raise RuntimeError(f"polish: FSC {fsc:.3f} Å against "
                           f"{fsc_unpolished:.3f} Å unpolished")
    return launches


# ---------------------------------------------------------------------------
# the learned models (pyp_tpu_torch/models): torch.nn on the card, no
# hand-written kernel; each phase reads shift_scored_match's launches (0)
# ---------------------------------------------------------------------------

# the JAX package's own bar (tests/test_models.py:45), read without
# failing: the JAX picker misses it on tools/e2e_spr micrographs too
# (tools/rehearse_models_jax.py nn 2048: recall 0.61; ROADMAP Queue 3)
NN_RECALL_BAR = 0.7
MEASURED_SECTOR_BAR = 1e-2     # of max|F| of the slice (tests/test_models.py:121)
MODEL_STEPS = dict(picker=300, membrane=400, miner=300, quality=300,
                   heterogeneity=500)   # the schema's defaults
HET_TILT_STEPS = 100   # the tilt branch, read without a bar: a short run


class _Window:
    """Counts shift_scored_match's launches, the device memory peak and
    the wall of a phase; `row()` reads them."""

    def __enter__(self):
        import torch

        from pyp_tpu_torch.ops import kernels

        kernels.shift_scored_match.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        return False

    def row(self):
        import torch

        from pyp_tpu_torch.ops import kernels

        torch.cuda.synchronize()
        return {"seconds": time.perf_counter() - self.t0,
                "max_memory_allocated_GiB":
                    torch.cuda.max_memory_allocated() / 2**30,
                "launches": kernels.shift_scored_match.launches}


def _copy_bundles(project, dst, names, drop=()):
    """A project holding the bundles `names` of `project` (their entries
    `drop` removed) and its parameter file."""
    import shutil

    os.makedirs(dst)
    for f in os.listdir(project):
        if f.startswith(".pyp_tpu_config"):
            shutil.copy(os.path.join(project, f), dst)
    for name in names:
        shutil.copy(os.path.join(project, f"{name}.meta.json"), dst)
        with np.load(os.path.join(project, f"{name}.meta.npz")) as z:
            arrays = {k: z[k] for k in z.files if k not in drop}
        np.savez_compressed(os.path.join(dst, f"{name}.meta.npz"), **arrays)
    return dst


def _stage(rows, name):
    return sum(sec for n, sec in rows if n == name)


def phase_models_spr(project, movies_dir, truth, root):
    """The SPA side of the models on the `spr` phase's project (three 40 x
    4096² movies): `sprtrain` on two bundles at the schema's defaults;
    `spr -detect_method nn` on the third movie (picks made; the recall
    within one particle radius read beside NN_RECALL_BAR, precision
    read); `spr -denoise_spr n2n`
    on a fresh project (the `spr` phase's recall and precision bars on
    the denoised picks), then `-prism_enable` on it (scores written);
    `prism` on the three bundles and a blank micrograph (every score
    finite, the blank's below the others' median). Returns the kernel
    launches."""
    import shutil

    from pyp_tpu_torch.io.metadata import ItemMetadata
    from pyp_tpu_torch.models import io as mio
    from pyp_tpu_torch.models.unet import UNet2D
    from pyp_tpu_torch.pipeline import spr as spr_pipe
    from pyp_tpu_torch.tools import e2e_spr

    names = sorted(truth)
    failures, launches = [], 0

    # sprtrain on the first two micrographs' picks
    train = _copy_bundles(project, os.path.join(root, "ms_train"), names[:2])
    with _Window() as w, _StageTimes() as st:
        out, wall = _cli_json(["sprtrain"], train)
    model = os.path.join(train, "picker_model.npz")
    mio.load_params(model, UNet2D((8, 16, 32)).state_dict())
    t_train = _stage(st.rows, "picker training")
    row = {"phase": "models_spr", "step": "sprtrain", **w.row(),
           "micrographs": out["micrographs"], "particles": out["particles"],
           "training_s": t_train,
           "training_steps_per_s": MODEL_STEPS["picker"] / t_train}
    launches += row["launches"]
    emit(row)

    # the learned picker on the third micrograph
    nn = _copy_bundles(project, os.path.join(root, "ms_nn"), names[2:],
                       drop=("box",))
    shutil.copy(model, nn)
    with _Window() as w, _StageTimes() as st:
        _cli_json(["spr", "-data_path",
                   os.path.join(movies_dir, f"{names[2]}.mrc"),
                   "-detect_method", "nn"], nn)
    meta = ItemMetadata(names[2], nn).load()
    recall, precision = e2e_spr.pick_recall_precision(
        meta["box"][:, :2], truth[names[2]]["centres"],
        e2e_spr.PARTICLE_RADIUS_A)
    ny, nx = meta["average"].shape
    tiles = ((ny - 128) // 64 + 1) * ((nx - 128) // 64 + 1)
    t_pick = _stage(st.rows, "NN particle picking")
    row = {"phase": "models_spr", "step": "detect_nn", **w.row(),
           "picks": int(len(meta["box"])),
           "planted": len(truth[names[2]]["centres"]), "recall": recall,
           "precision": precision, "recall_bar_met": recall >= NN_RECALL_BAR,
           "picking_s": t_pick, "inference_tiles": tiles,
           "inference_tiles_per_s": tiles / t_pick}
    launches += row["launches"]
    emit(row)
    if not len(meta["box"]):
        failures.append("detect_nn: no picks")

    # the noise2noise micrograph denoiser on a fresh project, then
    # -prism_enable on it
    n2n = os.path.join(root, "ms_n2n")
    os.makedirs(n2n)
    spr_pipe._spr_denoiser_cache.clear()
    argv = e2e_spr.SPR_ARGS + ["-data_path",
                               os.path.join(movies_dir, "movie_*.mrc"),
                               "-denoise_spr", "n2n"]
    with _Window() as w, _StageTimes() as st:
        _cli_json(argv, n2n)
    row = {"phase": "models_spr", "step": "denoise_n2n", **w.row(),
           "denoise_s": [sec for n, sec in st.rows
                         if n == "micrograph denoise"]}
    for name in names:
        meta = ItemMetadata(name, n2n).load()
        r, p = e2e_spr.pick_recall_precision(
            meta["box"][:, :2], truth[name]["centres"],
            e2e_spr.PARTICLE_RADIUS_A / 2)
        row[f"{name}_recall"], row[f"{name}_precision"] = r, p
        if not (r >= PICK_RECALL_BAR and p >= PICK_PRECISION_BAR
                and meta.is_done("denoised")):
            failures.append(f"denoise_n2n {name}: recall {r:.3f}, "
                            f"precision {p:.3f}")
    with _Window() as w2, _StageTimes() as st:
        _cli_json(argv + ["-prism_enable"], n2n)
    scores = [ItemMetadata(n, n2n).load().scalars.get("prism_score")
              for n in names]
    row.update(prism_enable=w2.row(), prism_enable_scores=scores)
    launches += row["launches"] + row["prism_enable"]["launches"]
    emit(row)
    if not all(s is not None and np.isfinite(s) for s in scores):
        failures.append(f"prism_enable wrote {scores}")
    spr_pipe._spr_denoiser_cache.clear()

    # prism on the three micrographs and a blank one
    pr = _copy_bundles(project, os.path.join(root, "ms_prism"), names)
    avg = ItemMetadata(names[0], project).load()["average"]
    blank = ItemMetadata("blank", pr)
    blank["average"] = (avg.mean() + avg.std() * np.random.RandomState(9)
                        .randn(*avg.shape)).astype(np.float32)
    blank.save()
    with _Window() as w, _StageTimes() as st:
        out, _ = _cli_json(["prism"], pr)
    scores = {n: ItemMetadata(n, pr).load().scalars["prism_score"]
              for n in names + ["blank"]}
    t_q = _stage(st.rows, "quality training")
    row = {"phase": "models_spr", "step": "prism", **w.row(),
           "items": out["items"], "scores": scores, "training_s": t_q,
           "training_steps_per_s": MODEL_STEPS["quality"] / t_q}
    launches += row["launches"]
    emit(row)
    others = [scores[n] for n in names]
    if not (all(np.isfinite(list(scores.values())))
            and scores["blank"] < np.median(others)):
        failures.append(f"prism: scores {scores}")
    if launches:
        failures.append(f"models_spr launched shift_scored_match {launches}")
    if failures:
        raise RuntimeError("models_spr bars failed: " + "; ".join(failures))
    return launches


def _virion_errors(meta, truth, tt, shape):
    """Surface picking read against the planted virions: the centroid of
    the refined surface's picks nearest each virion and the `vir` row's
    mean refined radius (the seed's integer centre reported beside)."""
    vir, picks = meta["vir"], meta["box"][:, :3]
    planted = tt.voxels([v["centre"] for v in truth["virions"]], shape)
    radii = np.array([v["radius"] for v in truth["virions"]]) / TOMO_REC_PIXEL
    owner = np.argmin(np.linalg.norm(picks[:, None] - planted[None], axis=-1), 1)
    seed_err, centre_err, radius_err = [], [], []
    for i, (c, r) in enumerate(zip(planted, radii)):
        d = np.linalg.norm(vir[:, :3] - c, axis=1)
        j = int(np.argmin(d))
        near = picks[(owner == i) & (np.abs(np.linalg.norm(picks - c, axis=1) - r)
                                     < 0.5 * r)]
        seed_err.append(float(d[j]))
        centre_err.append(float(np.linalg.norm(near.mean(0) - c))
                          if len(near) else float("inf"))
        radius_err.append(float(abs(vir[j, 3] / r - 1.0)))
    row = {"virions_found": int(len(vir)), "surface_picks": int(len(picks)),
           "seed_centre_err_vox": seed_err,
           "surface_centre_err_vox": centre_err, "radius_rel_err": radius_err}
    ok = (max(centre_err) <= TOMO_VIRION_CENTRE_BAR_VOX
          and max(radius_err) <= TOMO_VIRION_RADIUS_BAR_REL)
    return row, ok


def phase_models_tomo(root, tt, base):
    """The tomography side of the models on copies of the `tomo` phase's
    bundle (512² x 256 at rec bin 8): -denoise_method n2n (finite; the
    denoised tomogram's slab cc with the truth beside the raw one's, read
    without a bar: the JAX algorithm lowers it too at 60 steps), wedge
    (finite, every (z, x) slice's measured sector unchanged within
    MEASURED_SECTOR_BAR), -tomo_vir_method nn (the surface bars of
    tomo_options (c)), `tomotrain` on the tomogram and its picks (the
    model written), `mine` at the defaults (every grid patch in one
    cluster, the .spk files and gallery written, the best cluster's share
    of planted particles read). Returns the kernel launches."""
    from pyp_tpu_torch.io import boxfiles, mrc
    from pyp_tpu_torch.models import io as mio
    from pyp_tpu_torch.models.unet import UNet2D
    from pyp_tpu_torch.tools import e2e_tomo

    truth = tt.truth
    failures, launches = [], 0

    def run(tag, argv, drop=("box",)):
        proj = _fork(base, os.path.join(root, tag), drop)
        with _Window() as w, _StageTimes() as st:
            _cli_json(argv, proj)
        return proj, w.row(), st.rows

    def slab(vol):
        import torch

        ref = tt.tomogram_truth(vol.shape)
        return e2e_tomo.slab_cc(torch.as_tensor(vol, device=ref.device), ref,
                                tt.offset, half=TOMO_SLAB_HALF)

    # (h) noise2noise on the even/odd-tilt halves
    proj, w, st = run("mt_n2n", ["tomo", "-denoise_method", "n2n",
                                 "-tomo_rec_force"], drop=())
    rec = mrc.read(os.path.join(proj, "ts01.rec.mrc")).astype(np.float32)
    den = mrc.read(os.path.join(proj, "ts01.den.mrc")).astype(np.float32)
    row = {"phase": "models_tomo", "step": "denoise_n2n", **w,
           "stages_s": dict(st), "tomogram_cc": slab(rec),
           "denoised_cc": slab(den), "finite": bool(np.isfinite(den).all())}
    # read without a bar: at the schema's 60 steps the JAX package's n2n
    # lowers the slab cc too (tools/rehearse_models_jax.py n2n; ROADMAP
    # Queue 3)
    row["denoised_cc_not_below"] = row["denoised_cc"] >= row["tomogram_cc"]
    launches += row["launches"]
    emit(row)
    if not row["finite"]:
        failures.append("denoise_n2n: a non-finite denoised tomogram")

    # (i) the missing-wedge restorer
    proj, w, st = run("mt_wedge", ["tomo", "-denoise_method", "wedge",
                                   "-tomo_rec_force"], drop=())
    rec = mrc.read(os.path.join(proj, "ts01.rec.mrc")).astype(np.float32)
    den = mrc.read(os.path.join(proj, "ts01.den.mrc")).astype(np.float32)
    # the sector the tilts measured (tests/test_models.py:121 computes it
    # so): frequencies within tilt_max of the kx axis
    kz = np.fft.fftfreq(rec.shape[0])[:, None]
    kx = np.fft.rfftfreq(rec.shape[2])[None, :]
    measured = (np.degrees(np.arctan2(np.abs(kz), np.abs(kx)))
                <= float(np.abs(truth["angles"]).max()))
    errs = []
    for y in np.linspace(0, rec.shape[1] - 1, 16).astype(int):
        f_in, f_out = np.fft.rfft2(rec[:, y, :]), np.fft.rfft2(den[:, y, :])
        errs.append(float(np.abs(f_out - f_in)[measured].max()
                          / np.abs(f_in).max()))
    row = {"phase": "models_tomo", "step": "denoise_wedge", **w,
           "stages_s": dict(st), "finite": bool(np.isfinite(den).all()),
           "measured_sector_rel_err_max": max(errs),
           "wedge_sector_gain": float(np.abs(np.fft.rfft2(
               den[:, rec.shape[1] // 2, :]))[~measured].sum()
               / max(np.abs(np.fft.rfft2(rec[:, rec.shape[1] // 2, :]))
                     [~measured].sum(), 1e-30))}
    launches += row["launches"]
    emit(row)
    if not (row["finite"] and max(errs) <= MEASURED_SECTOR_BAR):
        failures.append(f"denoise_wedge: measured sector changed by "
                        f"{max(errs):.3g}")

    # (j) virions from the membrane network (trained, 400 steps, patch 96)
    proj, w, st = run("mt_vir_nn", ["tomo", "-tomo_spk_method", "surface",
                                    "-tomo_vir_method", "nn",
                                    "-tomo_vir_rad", "300",
                                    "-tomo_vir_search_band", "0.5",
                                    "-tomo_vir_detect_max", "16"])
    meta = _tomo_meta(proj)
    shape = mrc.read_header(os.path.join(proj, "ts01.rec.mrc")).shape
    vrow, ok = _virion_errors(meta, truth, tt, shape)
    t_m = _stage(st, "membrane training")
    row = {"phase": "models_tomo", "step": "vir_nn", **w, "stages_s": dict(st),
           "membrane_training_steps_per_s": MODEL_STEPS["membrane"] / t_m,
           "model_written": os.path.exists(os.path.join(
               proj, "membrane_model.npz")), **vrow}
    launches += row["launches"]
    emit(row)
    if not (ok and row["model_written"]):
        failures.append(f"vir_nn: centre errors {vrow['surface_centre_err_vox']},"
                        f" radius errors {vrow['radius_rel_err']}")

    # (k) tomotrain on the tomogram and its picks
    proj = _fork(base, os.path.join(root, "mt_train"), drop=())
    boxfiles.write_spk(_tomo_meta(proj)["box"][:, :3],
                       os.path.join(proj, "ts01.spk"))
    with _Window() as w, _StageTimes() as st:
        out, _ = _cli_json(["tomotrain"], proj)
    mio.load_params(os.path.join(proj, "picker_model_tomo.npz"),
                    UNet2D((8, 16, 32)).state_dict())
    t_p = _stage(st.rows, "picker training")
    row = {"phase": "models_tomo", "step": "tomotrain", **w.row(),
           "slices": out["slices"], "training_s": t_p,
           "training_steps_per_s": MODEL_STEPS["picker"] / t_p}
    launches += row["launches"]
    emit(row)

    # (l) mining at the defaults (patch 16, stride 8, 8 clusters)
    proj = _fork(base, os.path.join(root, "mt_mine"), drop=())
    with _Window() as w, _StageTimes() as st:
        out, _ = _cli_json(["mine"], proj)
    gallery = json.load(open(os.path.join(proj, "mine_gallery.json")))["ts01"]
    grid = int(np.prod([(d - 16) // 8 + 1 for d in shape]))
    planted = tt.voxels(truth["particles"], shape)
    rad = truth["particle_radius"] / TOMO_REC_PIXEL
    shares = []
    for c in gallery:
        path = os.path.join(proj, f"ts01_cluster{c['cluster']:02d}.spk")
        if not c["size"]:
            continue
        coords = np.asarray(boxfiles.read_spk(path))[:, :3]
        d = np.linalg.norm(coords[:, None] - planted[None], axis=-1)
        shares.append((float((d.min(1) <= rad).mean()),
                       float((d.min(0) <= rad).mean()), c["cluster"],
                       int(len(coords))))
    best = max(shares)
    t_t, t_mine = _stage(st.rows, "miner training"), _stage(st.rows, "mining")
    row = {"phase": "models_tomo", "step": "mine", **w.row(),
           "clusters": out["clusters"], "patches": grid,
           "cluster_sizes": [c["size"] for c in gallery],
           "best_cluster": best[2], "best_cluster_size": best[3],
           "best_cluster_share_on_particles": best[0],
           "best_cluster_particles_covered": best[1],
           "training_steps_per_s": MODEL_STEPS["miner"] / t_t,
           "mining_s": t_mine, "mining_patches_per_s": grid / t_mine}
    launches += row["launches"]
    emit(row)
    if not (sum(row["cluster_sizes"]) == grid
            and all(os.path.exists(os.path.join(
                proj, f"ts01_cluster{c['cluster']:02d}.spk"))
                for c in gallery if c["size"])):
        failures.append(f"mine: cluster sizes {row['cluster_sizes']} of "
                        f"{grid} patches")
    if launches:
        failures.append(f"models_tomo launched shift_scored_match {launches}")
    if failures:
        raise RuntimeError("models_tomo bars failed: " + "; ".join(failures))
    return launches


def phase_heterogeneity():
    """`heterogeneity` (the SPA branch) at the schema's defaults (latent 8,
    500 steps, batch 32, 60-8 Å) on classify3d's two states x 2,048 at
    consensus poses: the latents' PC1 split at its median separates the
    states (purity >= PURITY_BAR, tests/test_heterogeneity.py:40), and
    each end of PC1 decodes closer to its own state. Returns the kernel
    launches."""
    from pyp_tpu_torch.io import mrc
    from pyp_tpu_torch.models import heterogeneity as het
    from pyp_tpu_torch.tools import e2e_class

    data, synth_s = _sync_s(lambda: e2e_class.two_state_dataset(
        device="cuda"))
    vol_a, vol_b = data["volumes"]
    labels = data["labels"]
    with tempfile.TemporaryDirectory() as work:
        e2e_class.write_posed_project(work, data, vol_a)
        with _Window() as w, _StageTimes() as st:
            out, _ = _cli_json(["heterogeneity", "-scope_pixel", "1.0"], work)
        latents = np.load(os.path.join(work, "heterogeneity_latents.npz"))[
            "latents"]
        ends = [mrc.read(os.path.join(work, f"het_volume_{i:02d}.mrc"))
                for i in (0, out["volumes"] - 1)]
    pc, _, _ = het.latent_pca(latents, 1)
    low = pc[:, 0] <= np.median(pc[:, 0])
    purity = e2e_class.purity(low.astype(int), labels)
    # the state most particles of the low end belong to is its own
    own = [int(np.bincount(labels[low], minlength=2).argmax())]
    own.append(1 - own[0])
    ccs = [[e2e_class.cc(v, s) for s in (vol_a, vol_b)] for v in ends]
    closer = all(ccs[i][own[i]] > ccs[i][1 - own[i]] for i in (0, 1))
    t_h = _stage(st.rows, "heterogeneity training")
    row = {"phase": "heterogeneity", "branch": "spa", **w.row(),
           "synthesize_s": synth_s, "particles": out["particles"],
           "pc1_explained": out["pc1_explained"], "purity": purity,
           "end_vs_state_cc": ccs, "ends_closer_to_own_state": closer,
           "training_s": t_h,
           "training_steps_per_s": MODEL_STEPS["heterogeneity"] / t_h}
    emit(row)
    if not (purity >= PURITY_BAR and closer and not row["launches"]):
        raise RuntimeError(f"heterogeneity bars failed: purity {purity:.3f},"
                           f" end ccs {ccs}, launches {row['launches']}")
    return row["launches"]


def phase_heterogeneity_tilt(data_dir, root, tt, base):
    """`csp -csp_save_stacks` on the csp phase's start (a copy of its
    project), then `heterogeneity` on the exported tilt stacks (the
    tomoDRGN branch, HET_TILT_STEPS training steps): latents and volumes
    written and finite, read without a bar. Returns the kernel
    launches."""
    from pyp_tpu_torch.io import mrc
    from pyp_tpu_torch.tools import e2e_csp

    truth = tt.truth
    pixel, box, band = truth["pixel"], e2e_csp.CSP_BOX, e2e_csp.CSP_BAND
    _, keep, idx = _matched_picks(base, truth, 2048)
    rotations = e2e_csp.planted_rotations(truth)[idx]
    start = e2e_csp.start_eulers(rotations, e2e_csp.START_ERROR_DEG, seed=1)
    ref = e2e_csp.reference(truth, box, pixel)
    proj = _csp_project(base, root, "het_tilt", truth, start, box, ref,
                        pixel, keep)
    with _Window() as w:
        _cli_json(["csp", "-scope_pixel", str(pixel), "-scope_voltage",
                   "300", "-scope_cs", "2.7", "-scope_wgh", "0.07",
                   "-csp_box", str(box), "-csp_rlref", str(band[0]),
                   "-csp_rhref", str(band[1]), "-csp_transreg", "0",
                   "-tomo_rec_thickness", "2048", "-csp_parfile", "start",
                   "-no_plot_per_item", "-csp_save_stacks", "-data_path",
                   os.path.join(data_dir, "ts01.mrc")], proj)
    csp_row = w.row()
    with np.load(os.path.join(proj, "stacks", "ts01_stack.npz")) as z:
        stacks_shape = list(z["stacks"].shape)
    with _Window() as w, _StageTimes() as st:
        out, _ = _cli_json(["heterogeneity", "-het_steps",
                            str(HET_TILT_STEPS)], proj)
    latents = np.load(os.path.join(proj, "heterogeneity_latents.npz"))[
        "latents"]
    vols = [mrc.read(os.path.join(proj, f"het_volume_{i:02d}.mrc"))
            for i in range(out["volumes"])]
    t_h = _stage(st.rows, "heterogeneity training")
    row = {"phase": "heterogeneity", "branch": "tilt", **w.row(),
           "csp_save_stacks": csp_row, "stacks_shape": stacks_shape,
           "particles": out["particles"], "tilts": out["tilts"],
           "latents_shape": list(latents.shape),
           "finite": bool(np.isfinite(latents).all()
                          and all(np.isfinite(v).all() for v in vols)),
           "pc1_explained": out["pc1_explained"], "training_s": t_h,
           "training_steps_per_s": HET_TILT_STEPS / t_h}
    emit(row)
    launches = row["launches"] + csp_row["launches"]
    if not (row["finite"] and latents.shape[0] == stacks_shape[0]):
        raise RuntimeError(f"heterogeneity (tilt): {row}")
    if launches:
        raise RuntimeError(f"heterogeneity (tilt) launched "
                           f"shift_scored_match {launches} times")
    return launches


def phase_tomography():
    """The tomography phases on one synthetic series in a temporary
    directory (with the tomography side of the models), then CSP, SVA and
    the tilt branch of heterogeneity on their own project. Returns the
    kernel launches of the `tomo`, models, `csp`, `sva` and heterogeneity
    runs."""
    with tempfile.TemporaryDirectory() as root:
        data_dir = os.path.join(root, "data")
        tt = phase_tomo_synthesize(data_dir)
        launches, base = phase_tomo(data_dir, root, tt)
        phase_tomo_options(data_dir, root, tt, base)
        models = phase_models_tomo(root, tt, base)
        phase_tomo_mdoc(root, tt)
        phase_tomo_layers(data_dir, tt)
        phase_tomo_thick(root)
        csp, sva, het = phase_subtomo(root)
    return {"tomo": launches, "models_tomo": models, "csp": csp, "sva": sva,
            "heterogeneity_tilt": het}


def phase_subtomo(root):
    """The subtomogram phases on their own field: `tools/e2e_tomo.
    CSP_SERIES` (the tomo phase's series with a particle whose projections
    change with its orientation), synthesized and run through `tomo` at
    the same flags but template picking, then `csp` and `sva` on copies
    of that project.
    Returns the kernel launches of the csp, sva and heterogeneity (tilt)
    runs."""
    from pyp_tpu_torch.io import mrc
    from pyp_tpu_torch.tools import e2e_tomo

    data_dir = os.path.join(root, "csp_data")
    (truth, _), synth_s = _sync_s(lambda: e2e_tomo.write_series(
        data_dir, device="cuda", **e2e_tomo.CSP_SERIES))
    tt = _TomoTruth(truth)
    base = os.path.join(root, "csp_tomo")
    os.makedirs(base)
    # picked by template matching with the particle map (to ~1 voxel; the
    # slab picker's picks sit ~4 voxels off, too far for CSP's position
    # gradient steps)
    ref = os.path.join(root, "csp_particle.mrc")
    mrc.write(e2e_tomo.particle_map(truth, 32, TOMO_REC_PIXEL).cpu().numpy(),
              ref, pixel_size=TOMO_REC_PIXEL)
    merge, wall = _cli_json(e2e_tomo.TOMO_ARGS + [
        "-tomo_spk_method", "template", "-tomo_pick_ref", ref,
        "-data_path", os.path.join(data_dir, "ts01.mrc")], base)
    meta = _tomo_meta(base)
    shape = mrc.read_header(os.path.join(base, "ts01.rec.mrc")).shape
    rad = truth["particle_radius"] / TOMO_REC_PIXEL
    row = {"phase": "csp_tomo", "synthesize_s": synth_s, "seconds": wall,
           "particles": merge["particles"],
           **_tomo_alignment(meta, truth, [], "csp_tomo"),
           "recall_read": e2e_tomo.recall(meta["box"][:, :3],
                                          tt.voxels(truth["particles"], shape),
                                          rad)}
    emit(row)
    return (phase_csp(data_dir, root, tt, base), phase_sva(root, tt, base),
            phase_heterogeneity_tilt(data_dir, root, tt, base))



def main():
    import torch

    smi = phase_device()
    phase_build()
    k = phase_kernel()
    phase_tiff_lzw()
    data, init = phase_synthesize()
    launches, slice_ref = phase_slice(data, init)
    distributed = phase_distributed(data, init, slice_ref)
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
    het = phase_heterogeneity()
    preprocess = phase_preprocess(volume)
    csp_layers = phase_csp_layers()
    gather = phase_csp_gather()
    score = phase_csp_score()
    insert = phase_insert_scatter()
    phase_csp_graph()
    tomo_launches = phase_tomography()
    het += tomo_launches.pop("heterogeneity_tilt")
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "shift_scored_match", "route": "cuda",
        "source": "pyp_tpu_torch/csrc/shift_scored_match.cu",
        "replaces": "pyp_tpu/ops/pallas_kernels.py:80",
        "launches": {"slice": launches, "distributed": distributed,
                     "abinit_classic": classic,
                     "classify2d_gather": gather2d, **tomo_launches,
                     "csp_layers": csp_layers, **preprocess,
                     "heterogeneity": het},
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": "operations", "library_ms": k["library_ms"],
        "bound_fp32_ms": k["bound_fp32_ms"], "tflops": k["tflops"]}, {
        "name": "csp_slice_gather", "route": "cuda",
        "source": "pyp_tpu_torch/csrc/csp_slice_gather.cu",
        "replaces": None,
        "launches": {"csp_unit": [gather["unit_launches"],
                                  gather["unit_backward_launches"]]},
        "max_abs_err": gather["max_abs_err"], "ms": gather["kernel_ms"],
        "backward_ms": gather["backward_kernel_ms"],
        "plain_ms": gather["plain_ms"], "bound_ms": gather["bound_ms"],
        "bound_by": "bytes"}, {
        "name": "csp_score", "route": "cuda",
        "source": "pyp_tpu_torch/csrc/csp_score.cu", "replaces": None,
        "launches": {"csp_unit": [score["unit_launches"],
                                  score["unit_backward_launches"]]},
        "max_abs_err": score["csp_layers"]["max_abs_err"],
        "ms": score["csp_layers"]["forward_ms"],
        "backward_ms": score["csp_layers"]["backward_du_ms"],
        "plain_ms": score["csp_layers"]["plain_forward_ms"],
        "bound_ms": score["csp_layers"]["bound_ms"], "bound_by": "bytes"}, {
        "name": "insert_scatter", "route": "cuda",
        "source": "pyp_tpu_torch/csrc/insert_scatter.cu", "replaces": None,
        "launches": {"csp_unit": insert["unit_launches"]},
        "max_abs_err": insert["errors"]["num"]["max_abs_err"],
        "ms": insert["kernel_ms"], "plain_ms": insert["plain_ms"],
        "bound_ms": insert["bound_ms"], "bound_by": "bytes",
        "corner_atomics": insert["corner_atomics"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    if sys.argv[1:2] == ["--distributed-one"]:
        distributed_one(sys.argv[2])
    else:
        main()
