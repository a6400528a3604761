"""pyp_tpu_torch — the PyTorch/CUDA port of pyp_tpu for NVIDIA Hopper.

Mirrors `pyp_tpu`'s layout and function names module by module, so each
function's JAX counterpart is easy to find; `pyp_tpu` stays the reference
the port is tested against. The package imports `torch` and never `jax`.
It reuses only the JAX-free layers of `pyp_tpu` (io, config, utils,
stream.web, cli._project_params).

Ported slice: the SPA refinement loop with the gather engine
(`pipeline.refine.refine_loop` with `refine_engine=gather`), whose global
search scores through a hand-written CUDA kernel
(`ops.kernels.shift_scored_match`, source in `csrc/`).

Layout:
  pyp_tpu_torch.core      — geometry, CTF model, FFT crops, filters, FSC
  pyp_tpu_torch.ops       — Fourier-slice operators, refine3d, reconstruct,
                            the CUDA kernels and their build helper
  pyp_tpu_torch.pipeline  — the refinement loop
  pyp_tpu_torch.state     — state exchange with the JAX package
  pyp_tpu_torch.cli       — the `refine` mode
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device) -> torch.device:
    """torch.device for `device`; asking for CUDA where none is present
    raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False")
    return dev
