"""pyp_tpu_torch — the PyTorch/CUDA port of pyp_tpu for NVIDIA Hopper.

Mirrors `pyp_tpu`'s layout and function names module by module, so each
function's JAX counterpart is easy to find; `pyp_tpu` stays the reference
the port is tested against. The package imports `torch` and never `jax`,
and nothing of `pyp_tpu` either: it keeps its own copies of the JAX-free
layers it needs (`config`, the `io` codecs, `utils`, `stream.web`,
`stream.params`, `stream.metadb`, `sched`, and `cli`'s project
parameters), whose on-disk formats stay compatible, so a run resumes
across the two packages.

Ported: SPA preprocessing (`pipeline.spr`: movies through frame alignment
`ops.motion`, CTF estimation `ops.ctf_fit`, picking `ops.pick` and
extraction `ops.extract` to a particle stack; the modes `spr`, `extract`
and `gain`); the SPA gold-standard refinement loop (`pipeline.refine.refine_loop`)
with both pose-search engines — FRM (`ops.frm`, the default: polar
matching against a direction bank per half map, then a final sub-lattice
polish) and gather (whose global search scores through the hand-written
CUDA kernel `ops.kernels.shift_scored_match`, source in `csrc/`: a 3xTF32
tensor-core GEMM with the shift max as its epilogue) — with reference
auto-masking, per-particle defocus and beam-tilt refinement, and every
reconstruction option of the JAX loop (score shaping, likelihood
blurring, Ewald-sphere insertion, the sharpened final map, model fitting,
matching projections); the map modes `postprocess` (mask-corrected
FSC, sharpening, local resolution), `fsc` and `mask`; and tomography
(`pipeline.tomo`, the `tomo` mode: tilt-series alignment, per-tilt CTF,
WBP/SART reconstruction, denoising, segmentation and 3D picking over
`ops.tomo`, `ops.template_match`, `ops.filament` and
`ops.denoise_classic`); the streaming session daemon (`stream.daemon`,
the `stream` mode: movies preprocessed as they arrive, 2D classes kept
up to date, flag files and a metadata store for the web platform), the
workflow runner (`sched.workflow`) and the interchange modes (RELION,
FREALIGN, Warp, EMAN2, crYOLO and IMOD files); and the multi-GPU path
(`parallel`: `refine` and `csp` split over the ranks of a
torch.distributed group, one card each), SLURM submission
(`sched.bridge`, the `worker` mode) and the launcher
(`csrc/launcher.cpp`). The entry points
(`cli.main`, `pipeline.spr.process_micrograph`, `extract_stack`, the
alignment, CTF-fit, picking and extraction functions of `ops`,
`pipeline.refine.refine_loop`, `refinement_iteration`,
`ops.reconstruct.reconstruct`, `ops.refine3d.refine_batch`,
`ops.frm.FrmConfig`, `postprocess.core.postprocess_latest`,
`postprocess.locres.local_resolution`,
`analysis.modelfit.model_map_fit`, `pipeline.tomo.process_tilt_series`,
the tomography ops and `parallel.make_mesh` / `init_distributed`) run on
the card unless the caller passes `device="cpu"`.

Layout:
  pyp_tpu_torch.config      — parameter schema, CLI flags, project file
  pyp_tpu_torch.io          — MRC, .cistem and PDB codecs, STAR files,
                              RELION particle / tomogram stars, FREALIGN
                              .par, Warp .tomostar, EMAN2 HDF / LST, the
                              per-item metadata bundles, the TIFF (LZW
                              through the native pypio library), EER
                              and DM3/DM4 movie readers, .mdoc, IMOD
                              .xf / point models, coordinate files
  pyp_tpu_torch.utils       — logging, timers, log mirroring and mail
  pyp_tpu_torch.stream      — the session daemon, its params file and
                              metadata store, the web platform's client
  pyp_tpu_torch.sched       — job graphs, the local executor, workflows,
                              SLURM scripts (`bridge`, `SlurmExecutor`)
  pyp_tpu_torch.parallel    — several ranks, one card each: the process
                              group, the mesh, the sharded refine,
                              reconstruction and CSP functions
  pyp_tpu_torch.core        — geometry, CTF model, FFT helpers, filters, FSC
  pyp_tpu_torch.ops         — motion correction, CTF fitting, picking,
                              extraction, Fourier-slice operators, FRM,
                              refine3d, reconstruct, tilt-series
                              alignment and reconstruction, template
                              matching, filaments, denoisers, the CUDA
                              kernels and their build helper
  pyp_tpu_torch.postprocess — masks, the corrected FSC, sharpening, local
                              resolution
  pyp_tpu_torch.analysis    — score shaping, model fitting, plots, item
                              filters and selections, the HTML report
  pyp_tpu_torch.pipeline    — preprocessing (spr), tomography (tomo) and
                              the refinement loop
  pyp_tpu_torch.tools       — synthetic datasets with ground truth
                              (e2e_spa, e2e_spr, e2e_class, e2e_tomo),
                              the refine profiler
  pyp_tpu_torch.state       — state exchange with the JAX package
  pyp_tpu_torch.cli         — every mode of the JAX package (cli.PORTED)
"""

from __future__ import annotations

import numpy as np
import torch

__version__ = "0.1.0"


def as_f32(x, device) -> torch.Tensor:
    """float32 tensor on `device` from a numpy array, a sequence or a
    tensor."""
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return x.to(device=device, dtype=torch.float32)


def resolve_device(device) -> torch.device:
    """torch.device for `device`; asking for CUDA where none is present
    raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False")
    return dev


def rows_per_call(device, total: int, bytes_per_row: int) -> int:
    """Rows of a per-row computation to run at once on `device`: all of
    them on the CPU, else as many as fit a quarter of the card's free
    memory at `bytes_per_row`. Where each row's result depends only on
    that row, the split changes no result."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return max(1, total)
    free, _ = torch.cuda.mem_get_info(dev)
    return int(max(1, min(total, (free // 4) // max(1, bytes_per_row))))
