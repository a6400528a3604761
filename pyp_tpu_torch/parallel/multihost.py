"""Multi-process data path where each rank holds only its own chunk — the
torch port of pyp_tpu/parallel/multihost.py.

`parallel.spmd` takes the full inputs on every rank. Here every process
calls the `distributed_*` functions with ONLY its own range of the
particles (`process_range`), as a rank that reads its own share of a
large stack would; the accumulators merge with one all_reduce, and the
results come back replicated, so every rank can finalize identically
(rank 0 conventionally persists).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def process_range(total: int, nprocs: int | None = None,
                  pid: int | None = None) -> tuple[int, int]:
    """Contiguous [lo, hi) particle range owned by this process."""
    from pyp_tpu_torch.parallel.spmd import distributed

    if nprocs is None:
        nprocs = dist.get_world_size() if distributed() else 1
    if pid is None:
        pid = dist.get_rank() if distributed() else 0
    per = (total + nprocs - 1) // nprocs
    lo = min(pid * per, total)
    return lo, min(lo + per, total)


def distributed_accumulate(mesh, stack, poses, ctf_params, subset, weights,
                           n: int, pixel_size: float, voltage_kv=300.0,
                           cs_mm=2.7, amplitude_contrast=0.07,
                           symmetry="C1", pad=2, prev=None):
    """`spmd.sharded_accumulate` semantics with per-process local inputs:
    each rank inserts its own chunk (an empty chunk adds zeros) and one
    all_reduce merges. Returns Accumulators replicated on every rank."""
    from pyp_tpu_torch.ops import reconstruct as rec
    from pyp_tpu_torch.parallel.spmd import _reduce_acc

    dev = mesh.device
    if len(stack) and mesh.active:
        def on(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x)).to(device=dev, dtype=dtype)

        acc = rec.accumulate(
            on(stack), on(poses), on(ctf_params), on(subset, torch.int64),
            on(weights), n, pixel_size, voltage_kv, cs_mm,
            amplitude_contrast, symmetry, pad)
    else:
        acc = rec.zero_accumulators(n, pad, dev)
    acc = _reduce_acc(mesh, acc)
    if prev is not None:
        acc = rec.Accumulators(*(p + a for p, a in zip(prev, acc)))
    return acc


def distributed_reconstruct(stack, poses, ctf_params, pixel_size,
                            subset=None, weights=None, symmetry="C1",
                            voltage_kv=300.0, cs_mm=2.7,
                            amplitude_contrast=0.07, wiener=0.5,
                            batch: int = 256, pad: int = 2,
                            device="cuda"):
    """Full-stack reconstruction across the process group: each process
    feeds its local particle chunk in batches on `device` (its card); every
    process runs the same number of all_reduce rounds, from the largest
    chunk (an all_reduce MAX of the chunk sizes), and finalizes the merged
    accumulators. Call after `parallel.init_distributed()` joined."""
    from pyp_tpu_torch.ops import reconstruct as rec
    from pyp_tpu_torch.parallel.spmd import all_reduce_max, make_mesh

    mesh = make_mesh(device=device)
    B = int(np.asarray(stack).shape[0])
    if subset is None:
        subset = np.arange(B) % 2
    if weights is None:
        weights = np.ones(B, dtype=np.float32)
    n = int(np.asarray(stack).shape[-1])
    max_b = all_reduce_max(mesh, B)
    acc = None
    for i in range(0, max(max_b, 1), batch):
        sl = slice(min(i, B), min(i + batch, B))
        acc = distributed_accumulate(
            mesh, np.asarray(stack[sl]), np.asarray(poses[sl]),
            np.asarray(ctf_params[sl]), np.asarray(subset[sl]),
            np.asarray(weights[sl]), n, pixel_size, voltage_kv, cs_mm,
            amplitude_contrast, symmetry, pad, prev=acc)
    return rec.finalize(acc, n, pad, wiener)
