"""Data and model parallelism over the ranks of a torch.distributed group —
the torch port of pyp_tpu/parallel/spmd.py.

A JAX process sees every device of its mesh; here each rank drives one
device (one card, or the CPU), and a `Mesh` names how the ranks split the
work. Every rank holds the full inputs, as every JAX process sees the
global arrays:

  * axis "data" — rows (particles, projection windows, tilt series) are
    split into contiguous per-rank blocks. Rows are padded to a multiple
    of the rank count by repeating the last row, as the JAX package's
    `_pad_batch` pads them; padded rows carry weight 0 in the
    accumulators and are cut off the per-row outputs;
  * axis "model" — only `sharded_refine_step` computes along it: each
    model rank holds a slice of the mask points and the partial
    correlation sums are summed over the model subgroup;
  * merges: accumulators by `all_reduce(SUM)` (JAX's psum), per-row
    outputs by `all_gather` in rank order. Results are replicated on every
    rank of the mesh, as JAX's `out_specs=P()`.

In the pipeline functions (`sharded_refine_batch`, `sharded_accumulate`,
`sharded_accumulate_matrices`, `reconstruct_sharded`,
`csp_refine_batch_sharded`) the model axis changes nothing numeric: the
rows are split over data x model ranks, as JAX's `_dp_spec` flattens both
axes. Ranks beyond data x model take no rows and add zeros, as the JAX
mesh leaves those devices out; they still receive the pipeline functions'
results. `sharded_refine_step` and `sharded_reconstruct` reduce over
subgroups, and a rank outside the mesh gets None from them.

Under the gloo backend the collectives copy CUDA tensors to the host and
back; the compute stays on the card. Without an initialized process group
a mesh has one rank and every collective is the identity.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from pyp_tpu_torch import as_f32, resolve_device
from pyp_tpu_torch.core.geometry import euler_to_matrix
from pyp_tpu_torch.ops import reconstruct as rec
from pyp_tpu_torch.ops import refine3d as r3
from pyp_tpu_torch.ops.fourier_slice import (
    gather_2d_hermitian,
    image_to_fourier,
    slice_at_points,
    volume_to_fourier,
)


@dataclass(eq=False)
class Mesh:
    """A ("data", "model") arrangement of the group's ranks: rank r is data
    index r // model and model index r % model; ranks from data * model on
    are outside the mesh. `data_group` holds the ranks sharing this rank's
    model index, `model_group` those sharing its data index (None where
    no collective needs them)."""
    rank: int
    world_size: int
    data: int
    model: int
    device: torch.device
    backend: str | None
    data_group: object = None
    model_group: object = None

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def active(self) -> bool:
        return self.rank < self.size

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}


def distributed() -> bool:
    """True inside an initialized torch.distributed group."""
    return dist.is_available() and dist.is_initialized()


_MESHES: dict = {}


def make_mesh(n_devices: int | None = None, model: int = 1,
              device="cuda") -> Mesh:
    """A ("data", "model") mesh over the first `n_devices` ranks (all by
    default) of the process group, computing on `device` (on the card this
    rank pinned). Every rank must call it with the same arguments, in the
    same order: the subgroups are created collectively, once per
    arrangement."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    world = dist.get_world_size() if distributed() else 1
    rank = dist.get_rank() if distributed() else 0
    n_devices = world if n_devices is None else int(n_devices)
    model = max(1, int(model))
    data = min(n_devices, world) // model
    if data < 1:
        raise ValueError(f"a mesh of {n_devices} ranks with a model axis of "
                         f"{model} over a group of {world} has no data axis")
    key = (data, model, str(dev))
    mesh = _MESHES.get(key)
    if mesh is not None:
        return mesh
    backend = dist.get_backend() if distributed() else None
    data_group = model_group = None
    if distributed():
        size = data * model
        data_group = dist.group.WORLD
        if model > 1 or size < world:
            # new_group is collective: every rank creates every subgroup
            for m in range(model):
                g = dist.new_group([d * model + m for d in range(data)])
                if rank < size and rank % model == m:
                    data_group = g
        if model > 1:
            for d in range(data):
                g = dist.new_group([d * model + m for m in range(model)])
                if rank < size and rank // model == d:
                    model_group = g
    mesh = Mesh(rank, world, data, model, dev, backend, data_group,
                model_group)
    _MESHES[key] = mesh
    return mesh


# ---------------------------------------------------------------------------
# collectives: complex tensors travel as their real view; gloo moves CUDA
# tensors through the host
# ---------------------------------------------------------------------------


def _wire(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """A contiguous real copy of `x` for a collective, on the host under
    gloo."""
    y = torch.view_as_real(x) if x.is_complex() else x
    if mesh.backend == "gloo" and y.is_cuda:
        return y.cpu().contiguous()
    return y.clone(memory_format=torch.contiguous_format)


def _unwire(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    y = y.to(like.device)
    return torch.view_as_complex(y) if like.is_complex() else y


def all_reduce_sum(mesh: Mesh, x: torch.Tensor, group=None) -> torch.Tensor:
    """`x` summed over `group` (the world by default): a new tensor."""
    if not distributed():
        return x
    y = _wire(mesh, x.detach())
    dist.all_reduce(y, group=group)
    return _unwire(y, x)


def all_reduce_max(mesh: Mesh, value: int) -> int:
    """The largest of every rank's `value`."""
    if not distributed():
        return int(value)
    t = _wire(mesh, torch.tensor([int(value)], device=mesh.device))
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


def _reduce_acc(mesh: Mesh, acc, group=None) -> rec.Accumulators:
    return rec.Accumulators(*(all_reduce_sum(mesh, a, group) for a in acc))


def _all_gather(mesh: Mesh, x: torch.Tensor, group=None) -> list:
    n = dist.get_world_size(group)
    y = _wire(mesh, x)
    out = [torch.empty_like(y) for _ in range(n)]
    dist.all_gather(out, y, group=group)
    return [_unwire(o, x) for o in out]


def _gather_rows(mesh: Mesh, leaves, total: int) -> list:
    """Per-row outputs of the active ranks' blocks (each (per, ...), in rank
    order) concatenated over the world group and cut to `total` rows;
    `leaves` is None on a rank outside the mesh, which sends zeros shaped
    as rank 0's blocks."""
    if not distributed():
        return [leaf[:total] for leaf in leaves]
    if mesh.world_size > mesh.size:
        spec = [[(tuple(t.shape), t.dtype) for t in leaves]
                if mesh.rank == 0 else None]
        dist.broadcast_object_list(spec, src=0)
        if leaves is None:
            leaves = [torch.zeros(s, dtype=d, device=mesh.device)
                      for s, d in spec[0]]
    return [torch.cat(_all_gather(mesh, leaf)[:mesh.size])[:total]
            for leaf in leaves]


def gather_range(mesh: Mesh, leaves, total: int) -> list:
    """Per-row outputs of each rank's `multihost.process_range` of `total`
    rows (empty outside the mesh), gathered into full (total, ...) tensors
    on every rank."""
    per = max(1, math.ceil(total / mesh.size))
    padded = None
    if mesh.active:
        padded = [torch.cat([x, x.new_zeros((per - len(x),) + x.shape[1:])])
                  for x in leaves]
    return _gather_rows(mesh, padded, total)


# ---------------------------------------------------------------------------
# row blocks
# ---------------------------------------------------------------------------


def _block(n_rows: int, parts: int, index: int) -> np.ndarray:
    """Row indices of block `index` of `parts` over the rows padded to a
    multiple of `parts`: padding rows index the last row."""
    per = max(1, math.ceil(n_rows / parts))
    return np.minimum(np.arange(index * per, (index + 1) * per), n_rows - 1)


def _my_rows(mesh: Mesh, n_rows: int):
    """This rank's block of a data-parallel split over every mesh rank
    (None outside the mesh) and the mask of its real rows."""
    if not mesh.active:
        return None, None
    idx = _block(n_rows, mesh.size, mesh.rank)
    per = len(idx)
    real = np.arange(mesh.rank * per, (mesh.rank + 1) * per) < n_rows
    return idx, real


def _take(x, idx, device, dtype=torch.float32) -> torch.Tensor:
    """Rows `idx` of a numpy array or tensor, as `dtype` on `device`."""
    if isinstance(x, torch.Tensor):
        return x[torch.as_tensor(idx, device=x.device)].to(device=device,
                                                           dtype=dtype)
    return torch.as_tensor(np.asarray(x)[idx]).to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# model-axis local refinement
# ---------------------------------------------------------------------------


def sharded_refine_step(
    mesh: Mesh,
    stack,            # (B, n, n)
    ctf_params,       # (B, 4)
    ref_volume,       # (n, n, n)
    init_poses,       # (B, 5)
    pixel_size: float,
    low_res: float = 40.0,
    high_res: float = 8.0,
    iters: int = 16,
    voltage_kv: float = 300.0,
    cs_mm: float = 2.7,
    amplitude_contrast: float = 0.07,
):
    """One local-refinement pass sharded over particles (the data axis)
    and frequency points (the model axis): the gradient ascent of
    `refine3d.local_refine` (normalized gradients, 0.7 momentum, cosine
    decay, the final pose kept where it scores at least the initial one).

    Each model rank holds a slice of the band's mask points (padded to a
    multiple of the model axis with zero-validity points) and its partial
    num, |x|^2 and |c u|^2 sums are summed over the model subgroup by the
    autograd `all_reduce` of torch.distributed.nn. That all_reduce's
    backward sums the (identical) output gradients, so each rank's pose
    gradient is `model` times its own points' share; summing those shares
    over the subgroup and dividing by `model` gives the full gradient, as
    JAX's psum transposes. Returns (poses (B, 5), scores (B,)) replicated
    on the mesh's ranks; None outside the mesh."""
    from torch.distributed.nn.functional import all_reduce as ar_autograd

    if not mesh.active:
        return None
    dev = mesh.device
    B, n = int(stack.shape[0]), int(stack.shape[-1])
    Fref = volume_to_fourier(as_f32(ref_volume, dev))
    vol_pad = Fref.shape[0] // n
    pts = r3.make_mask_points(n, pixel_size, low_res, high_res)
    G = pts.shape[0]
    padG = (-G) % mesh.model
    valid = np.concatenate([np.ones(G, np.float32), np.zeros(padG, np.float32)])
    pts = np.concatenate([pts, np.zeros((padG, 2), np.float32)])
    chunk = (G + padG) // mesh.model
    mine = slice(mesh.model_index * chunk, (mesh.model_index + 1) * chunk)
    pts_s = as_f32(pts[mine], dev)
    valid_s = as_f32(valid[mine], dev)

    idx = _block(B, mesh.data, mesh.data_index)
    X = image_to_fourier(_take(stack, idx, dev))
    cp = _take(ctf_params, idx, dev)[:, :, None]
    pose0 = _take(init_poses, idx, dev)
    xv = gather_2d_hermitian(X, pts_s)                            # (b, g)
    c = r3._ctf_at_points(pts_s[None], n, pixel_size, cp[:, 0], cp[:, 1],
                          cp[:, 2], voltage_kv, cs_mm, amplitude_contrast,
                          cp[:, 3])
    xn_part = (valid_s * xv.abs() ** 2).sum(dim=1)
    model_group = mesh.model_group if distributed() else None

    def model_sum(x):
        if model_group is None:
            return x
        if mesh.backend == "gloo" and x.is_cuda:
            return ar_autograd(x.cpu(), group=model_group).to(x.device)
        return ar_autograd(x, group=model_group)

    def score(pose):
        R = euler_to_matrix(pose[:, 0], pose[:, 1], pose[:, 2])
        u = slice_at_points(R, pts_s, Fref, float(vol_pad))
        ph = 2.0 * np.pi * (pts_s[None, :, 0] * pose[:, 3:4]
                            + pts_s[None, :, 1] * pose[:, 4:5]) / n
        phasor = torch.complex(torch.cos(ph), torch.sin(ph))
        num = (valid_s * (xv.conj() * phasor * c * u).real).sum(dim=1)
        cn = (valid_s * c * c * u.abs() ** 2).sum(dim=1)
        num, xn, cn = model_sum(torch.stack([num, xn_part, cn]))
        return num / torch.sqrt(xn * cn + 1e-12)

    scale = torch.tensor([2.0, 2.0, 2.0, 0.4, 0.4], device=dev)
    pose = pose0.clone()
    m = torch.zeros_like(pose)
    for t in range(iters):
        p = pose.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(score(p).sum(), p)
        if model_group is not None:
            g = all_reduce_sum(mesh, g, model_group) / mesh.model
        gn = g / (torch.linalg.vector_norm(g, dim=1, keepdim=True) + 1e-8)
        m = 0.7 * m + gn
        decay = 0.5 * (1 + math.cos(math.pi * t / iters))
        pose = pose + scale * decay * m
    with torch.no_grad():
        sc0 = score(pose0)
        sc1 = score(pose)
    better = sc1 >= sc0
    poses = torch.where(better[:, None], pose, pose0)
    scores = torch.where(better, sc1, sc0)
    if not distributed():
        return poses[:B], scores[:B]
    return tuple(torch.cat(_all_gather(mesh, x, mesh.data_group))[:B]
                 for x in (poses, scores))


# ---------------------------------------------------------------------------
# pipeline-grade data parallelism: the production kernels run unchanged on
# each rank's rows, so the results match one device's (accumulators up to
# summation order)
# ---------------------------------------------------------------------------


def sharded_refine_batch(
    mesh: Mesh,
    stack,
    ctf_params,
    ref_volume,
    pixel_size: float,
    init_poses=None,
    shell_weights=None,
    **kw,
):
    """`refine3d.refine_batch` over the mesh: each rank runs the identical
    global and local search (the global search launches
    `shift_scored_match` on every rank) on its block of the rows; the
    per-row results are gathered in rank order. The production multi-GPU
    path of `pipeline.refine` (the reference's particle-range splits)."""
    B = int(stack.shape[0])
    idx, _ = _my_rows(mesh, B)
    leaves = None
    if idx is not None:
        dev = mesh.device
        res = r3.refine_batch(
            _take(stack, idx, dev), _take(ctf_params, idx, dev),
            as_f32(ref_volume, dev), pixel_size,
            init_poses=(None if init_poses is None
                        else _take(init_poses, idx, dev)),
            shell_weights=shell_weights, device=dev, **kw)
        leaves = list(res)
    return r3.RefineResult(*_gather_rows(mesh, leaves, B))


def sharded_accumulate(
    mesh: Mesh,
    stack, poses, ctf_params, subset, weights,
    n: int,
    pixel_size: float,
    voltage_kv: float = 300.0,
    cs_mm: float = 2.7,
    amplitude_contrast: float = 0.07,
    symmetry: str = "C1",
    pad: int = 2,
    prev=None,
    doses=None,
    gridding: str = "trilinear",
    iewald: int = 0,
    lblur=None,
    ref_fourier=None,
):
    """`reconstruct.accumulate` over the mesh with one all_reduce merge (the
    local_merge3d + merge3d of the reference). Padding rows get weight 0,
    so the result equals one device's accumulate up to summation order.
    Returns Accumulators replicated on every rank."""
    dev = mesh.device
    idx, real = _my_rows(mesh, int(stack.shape[0]))
    if idx is None:
        acc = rec.zero_accumulators(n, pad, dev)
    else:
        w = _take(weights, idx, dev) * torch.as_tensor(real, device=dev)
        acc = rec.accumulate(
            _take(stack, idx, dev), _take(poses, idx, dev),
            _take(ctf_params, idx, dev), _take(subset, idx, dev, torch.int64),
            w, n, pixel_size, voltage_kv, cs_mm, amplitude_contrast,
            symmetry, pad,
            doses=None if doses is None else _take(doses, idx, dev),
            gridding=gridding, iewald=iewald, lblur=lblur,
            ref_fourier=ref_fourier)
    acc = _reduce_acc(mesh, acc)
    if prev is not None:
        acc = rec.Accumulators(*(p + a for p, a in zip(prev, acc)))
    return acc


def sharded_accumulate_matrices(
    mesh: Mesh,
    windows, rotations, shifts, defoci, subset, weights,
    n: int,
    pixel_size: float,
    voltage_kv: float = 300.0,
    cs_mm: float = 2.7,
    amplitude_contrast: float = 0.07,
    pad: int = 2,
    prev=None,
    iewald: int = 0,
    ref_fourier=None,
):
    """`reconstruct.accumulate_matrices` (the CSPT matrix-pose insertion)
    over the mesh with one all_reduce merge; padding rows weigh 0."""
    dev = mesh.device
    idx, real = _my_rows(mesh, int(windows.shape[0]))
    if idx is None:
        acc = rec.zero_accumulators(n, pad, dev)
    else:
        w = _take(weights, idx, dev) * torch.as_tensor(real, device=dev)
        acc = rec.accumulate_matrices(
            _take(windows, idx, dev), _take(rotations, idx, dev),
            _take(shifts, idx, dev), _take(defoci, idx, dev),
            _take(subset, idx, dev, torch.int64), w, n, pixel_size,
            voltage_kv, cs_mm, amplitude_contrast, pad, iewald=iewald,
            ref_fourier=ref_fourier)
    acc = _reduce_acc(mesh, acc)
    if prev is not None:
        acc = rec.Accumulators(*(p + a for p, a in zip(prev, acc)))
    return acc


def reconstruct_sharded(
    mesh: Mesh,
    stack, poses, ctf_params, pixel_size,
    subset=None, weights=None, symmetry: str = "C1",
    voltage_kv: float = 300.0, cs_mm: float = 2.7,
    amplitude_contrast: float = 0.07, wiener: float = 0.5,
    batch: int = 256, pad: int = 2, crop_to: int = None,
    gridding: str = "trilinear", iewald: int = 0,
    lblur_nrot: int = 0, lblur_range: float = 20.0,
    ref_volume=None,
):
    """The mesh's `reconstruct.reconstruct`: each rank inserts its
    contiguous range of the stack (`multihost.process_range`) in batches
    of `batch` with `reconstruct.accumulate_stack` — crop_to, IEWALD ±2
    against `ref_volume` and likelihood blurring as there — one all_reduce
    merges, and every rank finalizes. The crop grid's pad factor is
    `reconstruct`'s max(2, round(pad n / n_rec)), so a mesh reconstructs
    what one device does (the JAX package's mesh path rounds it up)."""
    from pyp_tpu_torch.parallel.multihost import process_range

    B = int(stack.shape[0])
    lo, hi = (process_range(B, mesh.size, mesh.rank) if mesh.active
              else (B, B))
    acc, n_rec, pad_rec = rec.accumulate_stack(
        stack, poses, ctf_params, pixel_size, subset=subset, weights=weights,
        symmetry=symmetry, voltage_kv=voltage_kv, cs_mm=cs_mm,
        amplitude_contrast=amplitude_contrast, batch=batch, pad=pad,
        gridding=gridding, crop_to=crop_to, iewald=iewald,
        lblur_nrot=lblur_nrot, lblur_range=lblur_range,
        ref_volume=ref_volume, rows=slice(lo, hi), device=mesh.device)
    return rec.finalize(_reduce_acc(mesh, acc), n_rec, pad_rec, wiener,
                        gridding)


def sharded_reconstruct(
    mesh: Mesh,
    stack, poses, ctf_params,
    pixel_size: float,
    voltage_kv: float = 300.0,
    cs_mm: float = 2.7,
    amplitude_contrast: float = 0.07,
    pad: int = 2,
):
    """Particle-sharded insertion (half sets by row parity, unit weights)
    with one sum over the data subgroup — the merge3d. Model ranks of one
    data index insert the same rows. Returns Accumulators replicated on the
    mesh's ranks; None outside the mesh."""
    if not mesh.active:
        return None
    dev = mesh.device
    B, n = int(stack.shape[0]), int(stack.shape[-1])
    idx = _block(B, mesh.data, mesh.data_index)
    per = len(idx)
    real = np.arange(mesh.data_index * per, (mesh.data_index + 1) * per) < B
    acc = rec.accumulate(
        _take(stack, idx, dev), _take(poses, idx, dev),
        _take(ctf_params, idx, dev),
        torch.as_tensor(idx % 2, device=dev),
        torch.as_tensor(real, dtype=torch.float32, device=dev), n,
        pixel_size, voltage_kv, cs_mm, amplitude_contrast, "C1", pad)
    return _reduce_acc(mesh, acc, mesh.data_group)


def csp_refine_batch_sharded(
    mesh: Mesh,
    params_b,            # CspParams, every leaf (S, ...)
    xv_b,                # (S, T, P, G) complex window samples
    window_centers_b,    # (S, T, P, 2)
    tilt_defocus_b,      # (S, T, 2)
    mask_pts, Fref,      # shared
    tilt_weights_b,      # (S, T)
    valid_b,             # (S, T, P)
    offsets_by_mode, spin_offsets,
    modes: tuple,
    n: int,
    pixel_size: float,
    iters_per_mode: int = 20,
    lr: float = 0.3,
    reg_weight: float = 0.1,
    voltage_kv: float = 300.0,
    cs_mm: float = 2.7,
    amplitude_contrast: float = 0.07,
    step_tol: float = 0.0,
    value_tol: float = 0.0,
    series_vmap: bool = False,
):
    """`ops.csp.csp_refine_batch` with the SERIES axis split over the mesh
    (CSP has no model-parallel dimension; the reference fans one SLURM
    array element per series). S pads to a multiple of the rank count
    with zero-validity copies of the last series; each rank runs the mode
    schedule over its series (one after another, or vectorized with
    `series_vmap`), and the refined parameters, mode scores and particle
    scores are gathered in rank order and cut to S."""
    from pyp_tpu_torch.ops.csp import CspParams, csp_refine_batch

    S = int(valid_b.shape[0])
    idx, real = _my_rows(mesh, S)
    leaves = None
    if idx is not None:
        dev = mesh.device

        def take(x):
            return _take(x, idx, dev, x.dtype)

        v = take(valid_b) * torch.as_tensor(
            real, dtype=valid_b.dtype, device=dev)[:, None, None]
        refined, mode_scores, pscores = csp_refine_batch(
            CspParams(*(take(leaf) for leaf in params_b)), take(xv_b),
            take(window_centers_b), take(tilt_defocus_b), mask_pts, Fref,
            take(tilt_weights_b), v, offsets_by_mode, spin_offsets, modes,
            n, pixel_size, iters_per_mode=iters_per_mode, lr=lr,
            reg_weight=reg_weight, voltage_kv=voltage_kv, cs_mm=cs_mm,
            amplitude_contrast=amplitude_contrast, step_tol=step_tol,
            value_tol=value_tol, series_vmap=series_vmap)
        leaves = list(refined) + [mode_scores, pscores]
    out = _gather_rows(mesh, leaves, S)
    return CspParams(*out[:6]), out[6], out[7]
