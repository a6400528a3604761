"""Constrained single-particle tomography (CSP/CSPT) refinement — the torch
port of pyp_tpu/ops/csp.py.

Model. A particle p sits in the tomogram at position pos_p (centered voxel
coords) with orientation M_p = R(phi_p, theta_p, psi_p) (reference ->
tomogram). Tilt t maps tomogram to image: R_t = Rz(axis_t) @ Ry(tilt_t),
plus per-tilt image shift d_t. The particle's projection in tilt t has
pose R_eff = R_t @ M_p and lands at image position proj(R_t pos_p) + d_t;
its defocus is the tilt defocus plus the particle's depth along the beam.

All blocks are continuous inputs to one differentiable CTF-weighted
correlation loss (through the Fourier-slice gather), so each refinement
mode is a set of blocks that take gradient steps (`torch.autograd.grad`
with respect to the mode's own blocks, `MODE_BLOCKS`); the trajectory
regularization (csp_transreg) is a quadratic penalty inside the same loss.

Series batches. Every function below takes parameters with an optional
leading series axis S (each `CspParams` leaf (S, T...) / (S, P...), the
windows (S, T, P, G), ...): the loss is then one value per series, and
the step normalization, momentum, termination gate and final keep-or-
revert choice are taken per series, so a batch of S series computes what
S separate calls compute. The step loop runs with no host read: the
termination criteria freeze the parameters through tensor gates with the
same trip count. So on the card, where a shape comes back, each mode's
steps are captured once as a CUDA graph and replayed (`ModeGraphs`), one
launch for its 20 steps.
"""

from __future__ import annotations

import math
import threading
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from pyp_tpu_torch import as_f32, resolve_device, rows_per_call
from pyp_tpu_torch.core.geometry import euler_to_matrix, rot_y, rot_z
from pyp_tpu_torch.ops.fourier_slice import (
    gather_2d_hermitian,
    image_to_fourier,
)
from pyp_tpu_torch.ops import kernels
from pyp_tpu_torch.ops.kernels import csp_slice_gather
from pyp_tpu_torch.ops.refine3d import make_mask_points
from pyp_tpu_torch.utils.timer import span


class CspParams(NamedTuple):
    """All refinable quantities for one tilt-series (or a batch of them,
    each leaf with a leading series axis)."""
    tilt_angles: torch.Tensor    # (T,) degrees
    axis_angles: torch.Tensor    # (T,) degrees (in-plane tilt axis)
    tilt_shifts: torch.Tensor    # (T, 2) pixels (y, x) image shifts
    particle_eulers: torch.Tensor  # (P, 3) (phi, theta, psi) degrees
    particle_pos: torch.Tensor   # (P, 3) (z, y, x) centered tomogram voxels
    defocus_offsets: torch.Tensor  # (T,) Å added to the nominal tilt defocus


def make_params(tilt_angles, axis_angles, tilt_shifts, particle_eulers,
                particle_pos, defocus_offsets=None, device="cuda") -> CspParams:
    """CspParams of float32 tensors on `device` from arrays or tensors."""
    dev = resolve_device(device)
    if defocus_offsets is None:
        defocus_offsets = np.zeros(np.shape(tilt_angles)[-1], np.float32)
    return CspParams(*(as_f32(x, dev) for x in (
        tilt_angles, axis_angles, tilt_shifts, particle_eulers,
        particle_pos, defocus_offsets)))


# mode -> which blocks get gradients (reference mode table align/core.py:1015)
MODE_BLOCKS = {
    0: ("tilt_angles", "axis_angles"),          # tilt geometry angles
    1: ("particle_eulers",),                    # particle rotations
    2: ("particle_pos",),                       # particle shifts (3D)
    3: ("tilt_shifts",),                        # micrograph shifts
    4: ("defocus_offsets",),                    # per-tilt defocus
    5: ("tilt_shifts",),                        # patch micrograph variant
    6: ("particle_pos",),                       # patch particle-shift variant
    7: ("particle_eulers",),                    # patch particle-rotation variant
}

# which axis a mode's searched block varies over: per-tilt blocks reduce the
# score over particles (and vice versa), so one evaluation scores every
# tilt's (or particle's) candidate at once
MODE_AXIS = {0: "tilt", 3: "tilt", 4: "tilt", 5: "tilt",
             1: "particle", 2: "particle", 6: "particle", 7: "particle"}

# modes whose block does not move the reference-slice gather points
# (translations are phase ramps, defocus is an analytic CTF): one gather
# serves every candidate and step
SHIFT_MODES = (2, 3, 4, 5, 6)

# modes whose block moves neither particle depth nor the defocus offsets:
# the (T, P) defocus is computed once
CTF_CONST_MODES = (1, 3, 5, 7)

# per-block step scales (degrees / pixels / Å)
STEP_SCALES = CspParams(0.2, 0.2, 0.5, 1.0, 0.5, 100.0)


def _per_series(v, leaf):
    """A per-series value (S,) (or a scalar) shaped to broadcast against a
    leaf with the same leading axes."""
    return v.reshape(v.shape + (1,) * (leaf.dim() - v.dim()))


def tilt_rotation(tilt_deg, axis_deg):
    """R_t = Rz(axis) @ Ry(tilt): tomogram -> image frame (batched)."""
    return rot_z(axis_deg) @ rot_y(tilt_deg)


def _image_frame(params: CspParams):
    """(..., T, P, 3) image-frame xyz of every particle in every tilt."""
    R = tilt_rotation(params.tilt_angles, params.axis_angles)  # (..., T, 3, 3)
    pos_xyz = params.particle_pos.flip(-1)                    # (..., P, 3)
    return (R[..., :, None, :, :] @ pos_xyz[..., None, :, :, None])[..., 0]


def project_positions(params: CspParams):
    """Predicted image positions (..., T, P, 2) = (y, x), centered coords."""
    yx = _image_frame(params)[..., :2].flip(-1)
    return yx + params.tilt_shifts[..., :, None, :]


def particle_depth(params: CspParams):
    """Depth along the beam (z of the image frame) per (T, P) — defocus
    offset in pixels (DefocusOffsetFromCenter, geometry/core.py:686)."""
    return _image_frame(params)[..., 2]


def effective_rotations(params: CspParams):
    """(..., T, P, 3, 3) pose of each particle's projection: R_t @ M_p."""
    R_t = tilt_rotation(params.tilt_angles, params.axis_angles)
    e = params.particle_eulers
    M_p = euler_to_matrix(e[..., 0], e[..., 1], e[..., 2])
    return R_t[..., :, None, :, :] @ M_p[..., None, :, :, :]


def gather_2d_hermitian_batched(F, pts):
    """gather_2d_hermitian of spectra F (..., n, nxf) at points (G, 2):
    (..., G)."""
    return gather_2d_hermitian(F, pts)


@span("csp.gather")
def _csp_model_gather(params, mask_pts, Fref, n):
    """Reference central-slice values (..., T, P, G) at the mask points for
    the current geometry angles — the only gather in the scoring path. On
    the card one kernel forward and one backward (`ops.kernels.
    csp_slice_gather`); on the CPU the elementwise chain through
    gather_3d_hermitian."""
    vol_pad = Fref.shape[0] // n
    R_eff = effective_rotations(params)                  # (..., T, P, 3, 3)
    return csp_slice_gather(R_eff, mask_pts, Fref, float(vol_pad))


def _csp_df(params, tilt_defocus, pixel_size):
    """(..., T, P) defocus (Å) of every projection for the current geometry:
    mean tilt defocus + per-tilt offset + particle-depth defocus gradient."""
    depth = particle_depth(params)                       # (..., T, P)
    return (tilt_defocus[..., :, None, 0] + params.defocus_offsets[..., :, None]
            + depth * pixel_size)


def _csp_ncc(params, xv, window_centers, tilt_defocus, mask_pts, Fref,
             n, pixel_size, voltage_kv, cs_mm, amplitude_contrast,
             u=None, df=None):
    """Per-(tilt, particle) CTF-weighted NCC map (..., T, P); xv
    precomputed. `u` optionally carries precomputed reference slice values
    (SHIFT_MODES), `df` the precomputed defocus (CTF_CONST_MODES). The CTF,
    the shift's phase and the correlation are `ops.kernels.csp_score`: on
    the card one kernel forward and one backward, on the CPU the
    elementwise chain."""
    dshift = project_positions(params) - window_centers   # (..., T, P, 2)
    if u is None:
        u = _csp_model_gather(params, mask_pts, Fref, n)
    if df is None:
        df = _csp_df(params, tilt_defocus, pixel_size)
    return kernels.csp_score(dshift, df, xv, u, mask_pts, n, pixel_size,
                             voltage_kv, cs_mm, amplitude_contrast)


def csp_score(params: CspParams, windows_f, window_centers, tilt_defocus,
              mask_pts, Fref, tilt_weights, valid, n: int, pixel_size: float,
              voltage_kv: float = 300.0, cs_mm: float = 2.7,
              amplitude_contrast: float = 0.07, xv_precomputed: bool = False,
              u=None, df=None):
    """Mean CTF-weighted NCC over all (tilt, particle) projections, one
    value per series. windows_f: (..., T, P, n, nxf) centered spectra, or
    the gathered (..., T, P, G) values with xv_precomputed."""
    xv = (windows_f if xv_precomputed
          else gather_2d_hermitian_batched(windows_f, mask_pts))
    ncc = _csp_ncc(params, xv, window_centers, tilt_defocus, mask_pts, Fref,
                   n, pixel_size, voltage_kv, cs_mm, amplitude_contrast,
                   u=u, df=df)
    w = tilt_weights[..., :, None] * valid
    return torch.sum(ncc * w, (-2, -1)) / torch.clamp(torch.sum(w, (-2, -1)),
                                                      min=1.0)


def _smoothness_penalty(x):
    """Second-difference penalty along the tilt axis (-2) of (..., T, d):
    one value per series."""
    d2 = x[..., 2:, :] - 2 * x[..., 1:-1, :] + x[..., :-2, :]
    return torch.mean(d2 * d2, (-2, -1))


def _apply_mode_offset(params: CspParams, mode: int, off) -> CspParams:
    """Add an offset to the block a mode searches. `off` is (..., d) with
    the entity axis (tilt or particle) last of its leading axes, or (d,)
    broadcast over every entity."""
    if mode in (0,):
        return params._replace(
            tilt_angles=params.tilt_angles + off[..., 0],
            axis_angles=params.axis_angles + off[..., 1])
    if mode in (3, 5):
        return params._replace(tilt_shifts=params.tilt_shifts + off[..., 0:2])
    if mode in (4,):
        return params._replace(
            defocus_offsets=params.defocus_offsets + off[..., 0])
    if mode in (1, 7):
        return params._replace(
            particle_eulers=params.particle_eulers + off[..., 0:3])
    if mode in (2, 6):
        return params._replace(particle_pos=params.particle_pos + off[..., 0:3])
    raise ValueError(f"mode {mode} has no searchable block")


def make_mode_offsets(mode: int, tol, steps: int = 9,
                      random_iters: int = 0) -> np.ndarray:
    """Candidate offset grid for a mode (the csp_GS uniform build): (K, d)
    covering ±tol; tol a scalar or per-dimension tuple. random_iters adds
    that many uniform random candidates within the tolerance region
    (seed 0)."""
    out = _make_mode_offsets_grid(mode, tol, steps)
    if random_iters and random_iters > 0:
        rng = np.random.RandomState(0)
        tols = np.atleast_1d(np.asarray(tol, dtype=np.float32))
        d = out.shape[1]
        tvec = np.array([tols[min(i, len(tols) - 1)] for i in range(d)],
                        dtype=np.float32)
        rand = rng.uniform(-1.0, 1.0, (int(random_iters), d)).astype(
            np.float32) * tvec
        if mode in (2, 3, 5, 6):
            # shift modes search a disk of radius tol
            nrm = np.linalg.norm(rand, axis=1, keepdims=True)
            lim = tvec[0]
            rand = np.where(nrm > lim, rand * (lim / (nrm + 1e-9)), rand)
        out = np.concatenate([out, rand], axis=0)
    return out


def _make_mode_offsets_grid(mode: int, tol, steps: int = 9) -> np.ndarray:
    tols = np.atleast_1d(np.asarray(tol, dtype=np.float32))

    def axis(i, n_steps=steps):
        t = tols[min(i, len(tols) - 1)]
        return np.linspace(-t, t, n_steps, dtype=np.float32)

    if mode in (4,):
        return axis(0)[:, None]
    if mode in (0,):
        # joint (tilt angle, axis angle) grid; an axis tol of 0 collapses
        # to the tilt-angle-only search
        if len(tols) > 1 and tols[1] > 0:
            ax2 = axis(1, max(3, steps // 2))
        else:
            ax2 = np.zeros(1, dtype=np.float32)
        g = np.stack(np.meshgrid(axis(0), ax2, indexing="ij"), -1)
        return g.reshape(-1, 2)
    if mode in (3, 5):
        t = tols[0]
        g = np.stack(np.meshgrid(axis(0), axis(0), indexing="ij"), -1).reshape(-1, 2)
        return g[(g**2).sum(1) <= t**2 + 1e-6]
    if mode in (1, 7):
        g = np.stack(np.meshgrid(axis(0), axis(1), axis(2), indexing="ij"), -1)
        return g.reshape(-1, 3)
    if mode in (2, 6):
        t = tols[0]
        g = np.stack(np.meshgrid(axis(0), axis(0), axis(0), indexing="ij"), -1).reshape(-1, 3)
        return g[(g**2).sum(1) <= t**2 + 1e-6]
    raise ValueError(f"mode {mode} has no searchable block")


def make_spin_offsets(step_deg: float) -> np.ndarray:
    """Full in-plane spin ring (the phi column over 360°) for surface-
    normal orientation priors, whose phi is free."""
    phis = np.arange(-180.0, 180.0, float(step_deg), dtype=np.float32)
    off = np.zeros((len(phis), 3), dtype=np.float32)
    off[:, 0] = phis
    return off


def _grid_search_xv(
    params, xv, window_centers, tilt_defocus, mask_pts, Fref,
    tilt_weights, valid, offsets, mode, n, pixel_size,
    voltage_kv, cs_mm, amplitude_contrast,
):
    """Grid search of one mode's block on precomputed window samples xv
    (..., T, P, G): every candidate offset is scored for every tilt (or
    particle) at once, candidates in chunks sized from free device memory;
    each entity takes its first best candidate (argmax on the device).
    Returns (params, best score per entity)."""
    axis = MODE_AXIS[mode]
    offsets = torch.as_tensor(np.asarray(offsets, np.float32),
                              device=xv.device)
    K = offsets.shape[0]
    w = tilt_weights[..., :, None] * valid                  # (..., T, P)
    red = -1 if axis == "tilt" else -2
    wsum = torch.clamp(torch.sum(w, red), min=1e-6)
    with torch.no_grad():
        u0 = (_csp_model_gather(params, mask_pts, Fref, n)
              if mode in SHIFT_MODES else None)
        df0 = (_csp_df(params, tilt_defocus, pixel_size)
               if mode in CTF_CONST_MODES else None)
        # a candidate's working set: ~24 float32 values per (T, P, G) point
        # of the series in the gather and the NCC
        chunk = rows_per_call(xv.device, K, 24 * 4 * xv.numel())
        lead = params.tilt_angles.dim() - 1                 # series axes
        scores = []
        for lo in range(0, K, chunk):
            off = offsets[lo:lo + chunk]                    # (k, d)
            off = off.reshape((off.shape[0],) + (1,) * (lead + 1)
                              + off.shape[1:])              # (k, ..., 1, d)
            p2 = _apply_mode_offset(params, mode, off)
            ncc = _csp_ncc(p2, xv, window_centers, tilt_defocus, mask_pts,
                           Fref, n, pixel_size, voltage_kv, cs_mm,
                           amplitude_contrast, u=u0, df=df0)
            scores.append(torch.sum(ncc * w, red) / wsum)
        scores = torch.cat(scores)                          # (K, ..., E)
        best = torch.argmax(scores, dim=0)                  # (..., E)
        return (_apply_mode_offset(params, mode, offsets[best]),
                torch.amax(scores, dim=0))


class _Steps(NamedTuple):
    """The numbers a mode's step loop bakes in besides its tensors."""
    mode: int
    n: int
    pixel_size: float
    iters: int
    lr: float
    reg_weight: float
    voltage_kv: float
    cs_mm: float
    amplitude_contrast: float
    step_tol: float
    value_tol: float


def _mode_loss(p, b, h):
    """A mode's objective at parameters p, one value per series: the score
    on b's windows (with b's precomputed "u0" / "df0" where present) less
    the trajectory penalty."""
    score = csp_score(
        p, b["xv"], b["window_centers"], b["tilt_defocus"], b["mask_pts"],
        b["Fref"], b["tilt_weights"], b["valid"], h.n, h.pixel_size,
        h.voltage_kv, h.cs_mm, h.amplitude_contrast, xv_precomputed=True,
        u=b.get("u0"), df=b.get("df0"))
    reg = (_smoothness_penalty(p.tilt_shifts)
           + _smoothness_penalty(p.tilt_angles[..., None]))
    return score - h.reg_weight * reg


def _mode_buffers(params, xv, window_centers, tilt_defocus, mask_pts, Fref,
                  tilt_weights, valid, h: _Steps):
    """The tensors `_mode_steps` reads for mode h.mode from the start
    `params`: the parameters and windows, the reference's slice values "u0"
    (shift modes) and the defocus "df0" (modes that move neither depth nor
    defocus) at the start, and the start state."""
    b = dict(zip(CspParams._fields, params), xv=xv,
             window_centers=window_centers, tilt_defocus=tilt_defocus,
             mask_pts=mask_pts, Fref=Fref, tilt_weights=tilt_weights,
             valid=valid)
    if h.mode in SHIFT_MODES:
        b["u0"] = _csp_model_gather(params, mask_pts, Fref, h.n)
    if h.mode in CTF_CONST_MODES:
        b["df0"] = _csp_df(params, tilt_defocus, h.pixel_size)
    for k in MODE_BLOCKS[h.mode]:
        b["m." + k] = torch.zeros_like(b[k])
    lead = params.tilt_angles.shape[:-1]
    b["done"] = torch.zeros(lead, device=xv.device)
    b["prev"] = torch.full(lead, -math.inf, device=xv.device)
    return b


def _mode_steps(b, h: _Steps):
    """The h.iters gradient steps of mode h.mode on the tensors of `b`, in
    place. Reads the parameters (one entry per CspParams field), "xv",
    "window_centers", "tilt_defocus", "mask_pts", "Fref", "tilt_weights",
    "valid", "u0" / "df0" where the mode has them, and the state:
    "m.<block>" (the momentum), "done" and "prev". Writes the refined
    blocks into their entries and the final state into its own.

    A step: the normalized gradient with momentum 0.7 and a cosine-decayed
    step. step_tol / value_tol are the reference optimizer's termination
    criteria (csp_OptimizerStepTolerance / csp_OptimizerValueTolerance) as
    update freezing: once a series' step norm or score gain falls below
    its tolerance, its later steps do not move it (same trip count); 0 =
    off. Nothing reads the host, and nothing allocated here outlives the
    call, so the steps capture as one CUDA graph (ModeGraphs): each step's
    decay and the tolerance branch are baked in as Python numbers."""
    blocks = MODE_BLOCKS[h.mode]
    p = CspParams(*(b[f] for f in CspParams._fields))
    lead = p.tilt_angles.dim() - 1
    m = {k: b["m." + k] for k in blocks}
    done, prev = b["done"], b["prev"]

    def value_and_grad(p):
        leaves = {k: getattr(p, k).detach().requires_grad_(True)
                  for k in blocks}
        with torch.enable_grad():
            with span("csp.step.forward"):
                loss = _mode_loss(p._replace(**leaves), b, h)
                total = loss.sum()
            with span("csp.step.backward"):
                g = torch.autograd.grad(total, [leaves[k] for k in blocks])
        return loss.detach(), dict(zip(blocks, g))

    use_tols = h.step_tol > 0.0 or h.value_tol > 0.0
    scales = dict(zip(CspParams._fields, STEP_SCALES))
    for t in range(h.iters):
        with span("csp.step"):
            loss, g = value_and_grad(p)
            with span("csp.step.update"):
                # one gradient norm per series over the mode's blocks
                gsq = sum(torch.sum(gi * gi, tuple(range(lead, gi.dim())))
                          for gi in g.values())
                gnorm = torch.sqrt(gsq + 1e-12)
                decay = 0.5 * (1 + math.cos(math.pi * t / h.iters))
                gate = 1.0 - done
                upd = {}
                for k in blocks:
                    m[k] = 0.7 * m[k] + g[k] / _per_series(gnorm, g[k])
                    upd[k] = (_per_series(gate, m[k])
                              * (h.lr * decay * scales[k]) * m[k])
                p = p._replace(**{k: getattr(p, k) + upd[k] for k in blocks})
                if use_tols:
                    usq = sum(torch.sum(ui * ui, tuple(range(lead, ui.dim())))
                              for ui in upd.values())
                    unorm = torch.sqrt(usq + 1e-18)
                    stalled = torch.zeros_like(done, dtype=torch.bool)
                    if t > 0:
                        if h.value_tol > 0.0:
                            stalled = stalled | (loss - prev < h.value_tol)
                        if h.step_tol > 0.0:
                            stalled = stalled | (unorm < h.step_tol)
                    done = torch.maximum(done, stalled.to(done.dtype))
                    prev = loss
    with torch.no_grad():
        for k in blocks:
            b[k].copy_(getattr(p, k))
            b["m." + k].copy_(m[k])
        b["done"].copy_(done)
        b["prev"].copy_(prev)


_MAX_GRAPHS = 8      # captured step loops ModeGraphs keeps

# the hand-written kernels a step launches, whose launch counters a replay
# adds to
_COUNTED = (csp_slice_gather, kernels.csp_score)


class _Captured:
    """A captured step loop: its graph, the buffers it reads and writes,
    the key of the _Schedule whose buffers it shares, the (forward,
    backward) launches a replay makes of each kernel of _COUNTED, and the
    calls after its capture that replayed it."""

    def __init__(self, graph, bufs, blocks, schedule, launches):
        self.graph, self.bufs, self.blocks = graph, bufs, blocks
        self.schedule, self.launches = schedule, launches
        self.hits = 0


class _Schedule:
    """What the graphs of one schedule share: their buffers, one per name
    and signature, and one memory pool."""

    def __init__(self, device):
        self.bufs = {}
        self.pool = (torch.cuda.graph_pool_handle()
                     if device.type == "cuda" else None)
        self.users = 0


def _signature(t):
    return (tuple(t.shape), t.stride(), t.dtype, str(t.device))


def _eager_steps(b, h: _Steps) -> dict:
    """The refined blocks {name: tensor} of `_mode_steps` run as it is,
    on copies of b's blocks and state: b is left as it is."""
    blocks = MODE_BLOCKS[h.mode]
    state = [*blocks, *("m." + k for k in blocks), "done", "prev"]
    c = {**b, **{k: b[k].clone() for k in state}}
    _mode_steps(c, h)
    return {k: c[k] for k in blocks}


class ModeGraphs:
    """The step loops of `_refine_mode_xv` on the card as CUDA graphs,
    each captured once and replayed after: a cache of at most _MAX_GRAPHS
    graphs, the least recently used first out (its graph reset, so its
    pool's memory goes back to the allocator, and its buffers dropped with
    the last graph that shares them). A key (`key`) is every number the
    loop bakes in (_Steps: the mode, the box, the pixel size, the step
    count and each hyperparameter) and every tensor's name, shape,
    strides, dtype and device.

    A capture pays only where its key comes back: it costs about a second
    pass of the steps, where a replay saves most of one. So a key not in
    the cache is captured at its first call while the graphs captured so
    far come back, and at its second call, running eagerly at its first,
    once a graph has left the cache (evicted or cleared) that no call
    replayed after its capture. A replay of a cached graph makes the first
    call capture again. Zero steps run eagerly: there is nothing to
    capture.

    Only the main thread captures: a capture fails when another thread
    synchronises the card meanwhile (a `Timer` does at its end). The
    port's worker threads (`sched/executor`) refine series while the main
    thread waits for them; they replay what the cache holds and run the
    rest eagerly.

    The graphs of one schedule (every key but the mode and the mode's own
    tensors) share their buffers and one memory pool: they run one after
    another on the current stream, and each replay first copies in every
    tensor it reads. A capture warms up with two of the steps on a side
    stream, then captures them all. Every replay copies the tensors in,
    replays the graph and returns clones of the refined blocks, so no
    caller holds a buffer that the next replay overwrites. One lock
    covers the cache, each capture and each replay from copy-in to
    clone-out, so threads that share the card share the cache.

    Counters: `captures` and `replays`; each replay adds the launches of
    csp_slice_gather and csp_score its capture recorded to the kernels' own
    counters, which count what runs."""

    def __init__(self):
        self.captures = 0
        self.replays = 0
        self._graphs = OrderedDict()
        self._schedules = {}
        self._seen = OrderedDict()      # keys run eagerly once, not captured
        self._capture_at_first = True
        self._lock = threading.Lock()

    def __len__(self):
        return len(self._graphs)

    @staticmethod
    def key(h: _Steps, b: dict):
        return (h,) + tuple((name, _signature(t))
                            for name, t in sorted(b.items()))

    @staticmethod
    def _schedule_key(h: _Steps, b: dict):
        shared = [*CspParams._fields, "xv", "window_centers", "tilt_defocus",
                  "mask_pts", "Fref", "tilt_weights", "valid"]
        return (h._replace(mode=None),) + tuple(
            (name, _signature(b[name])) for name in shared)

    def run(self, h: _Steps, b: dict) -> dict:
        """The refined blocks {name: tensor} of `_mode_steps(b, h)`, as new
        tensors; b is left as it is."""
        key = self.key(h, b)
        with self._lock:
            entry = self._graphs.get(key)
            if entry is not None:
                self._graphs.move_to_end(key)
                entry.hits += 1
                self._capture_at_first = True
            elif h.iters and (threading.current_thread()
                              is threading.main_thread()):
                if self._capture_at_first or self._seen.pop(key, False):
                    entry = self._capture_new(key, h, b)
                else:
                    self._seen[key] = True
                    while len(self._seen) > _MAX_GRAPHS:
                        self._seen.popitem(last=False)
            if entry is not None:
                with span("csp.mode.graph", {"mode": h.mode, "capture": 0}):
                    for name, x in b.items():
                        entry.bufs[name].copy_(x)
                    entry.graph.replay()
                    self.replays += 1
                    for fn, (f, bw) in zip(_COUNTED, entry.launches):
                        fn.launches += f
                        fn.backward_launches += bw
                    return {k: entry.bufs[k].clone() for k in entry.blocks}
        return _eager_steps(b, h)

    def _capture_new(self, key, h, b):
        skey = self._schedule_key(h, b)
        sched = self._schedules.get(skey)
        if sched is None:
            sched = self._schedules[skey] = _Schedule(b["xv"].device)
        bufs = {}
        for name, x in b.items():
            buf = sched.bufs.get((name, _signature(x)))
            if buf is None:
                buf = sched.bufs[(name, _signature(x))] = torch.empty_like(x)
            bufs[name] = buf
        with span("csp.mode.graph", {"mode": h.mode, "capture": 1}):
            for name, x in b.items():
                bufs[name].copy_(x)
            graph, launches = self._capture(bufs, h, sched.pool)
        self.captures += 1
        sched.users += 1
        entry = self._graphs[key] = _Captured(graph, bufs, MODE_BLOCKS[h.mode],
                                              skey, launches)
        while len(self._graphs) > _MAX_GRAPHS:
            self._drop(self._graphs.popitem(last=False)[1])
        return entry

    @staticmethod
    def _capture(bufs, h, pool):
        """(a new CUDA graph of the steps of h on bufs, the (forward,
        backward) launches it recorded of each kernel of _COUNTED). Two of the steps run first on the capture's
        side stream: they launch every kernel the capture records (the
        second step's tolerance test too), so kernels load, and handles
        and autograd's device threads start, outside the capture. A
        capture launches nothing: its launches count at each replay."""
        with torch.cuda.device(bufs["xv"].device):
            graph = torch.cuda.CUDAGraph()
            # thread_local: another thread's allocation does not end it
            capture = torch.cuda.graph(graph, pool=pool,
                                       capture_error_mode="thread_local")
            side = capture.capture_stream
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                _mode_steps(bufs, h._replace(iters=min(h.iters, 2)))
            torch.cuda.current_stream().wait_stream(side)
            before = [(fn.launches, fn.backward_launches) for fn in _COUNTED]
            with capture:
                _mode_steps(bufs, h)
            launches = tuple((fn.launches - f0, fn.backward_launches - b0)
                             for fn, (f0, b0) in zip(_COUNTED, before))
            for fn, (f0, b0) in zip(_COUNTED, before):
                fn.launches, fn.backward_launches = f0, b0
        return graph, launches

    def _drop(self, entry):
        entry.graph.reset()
        if entry.hits == 0:
            self._capture_at_first = False
        sched = self._schedules[entry.schedule]
        sched.users -= 1
        if sched.users == 0:
            del self._schedules[entry.schedule]

    def clear(self):
        """Drop every graph and buffer, and forget the keys seen once."""
        with self._lock:
            while self._graphs:
                self._drop(self._graphs.popitem(last=False)[1])
            self._seen.clear()


# the card's captured step loops (ModeGraphs), one cache for the process
graph = ModeGraphs()


def _refine_mode_xv(
    params, xv, window_centers, tilt_defocus, mask_pts, Fref,
    tilt_weights, valid, mode, n, pixel_size, iters, lr, reg_weight,
    voltage_kv, cs_mm, amplitude_contrast,
    step_tol: float = 0.0, value_tol: float = 0.0,
):
    """Gradient ascent of one mode's blocks on precomputed window samples
    xv (..., T, P, G): `iters` steps (`_mode_steps`), then the refined
    parameters are kept only where they score at least the start's (per
    series). On the card the steps go through `graph`, which replays them
    as one CUDA graph per mode and shape where the shape comes back; on
    the CPU they run as they are. Returns (params, score per series)."""
    h = _Steps(int(mode), int(n), float(pixel_size), int(iters), float(lr),
               float(reg_weight), float(voltage_kv), float(cs_mm),
               float(amplitude_contrast), float(step_tol), float(value_tol))
    with span("csp.mode.start"), torch.no_grad():
        b = _mode_buffers(params, xv, window_centers, tilt_defocus, mask_pts,
                          Fref, tilt_weights, valid, h)
    refined = (graph.run(h, b) if xv.device.type == "cuda"
               else _eager_steps(b, h))
    p = params._replace(**refined)
    with span("csp.mode.keep"), torch.no_grad():
        s0 = _mode_loss(params, b, h)
        s1 = _mode_loss(p, b, h)
        better = s1 >= s0
        p_final = CspParams(*(torch.where(_per_series(better, a), b_, a)
                              for a, b_ in zip(params, p)))
        return p_final, torch.where(better, s1, s0)


def csp_grid_search_mode(params: CspParams, windows_f, window_centers,
                         tilt_defocus, mask_pts, Fref, tilt_weights, valid,
                         offsets, mode: int, n: int, pixel_size: float,
                         voltage_kv: float = 300.0, cs_mm: float = 2.7,
                         amplitude_contrast: float = 0.07):
    """Exhaustive discrete search of one mode's block (the csp_GS role) on
    window spectra (..., T, P, n, nxf): the score separates over the
    searched axis, so each tilt (or particle) takes its own best candidate.
    Follow with csp_refine_mode to polish."""
    xv = gather_2d_hermitian_batched(windows_f, mask_pts)
    return _grid_search_xv(
        params, xv, window_centers, tilt_defocus, mask_pts, Fref,
        tilt_weights, valid, offsets, mode, n, pixel_size,
        voltage_kv, cs_mm, amplitude_contrast)


def csp_refine_mode(params: CspParams, windows_f, window_centers,
                    tilt_defocus, mask_pts, Fref, tilt_weights, valid,
                    mode: int, n: int, pixel_size: float, iters: int = 20,
                    lr: float = 0.3, reg_weight: float = 0.1,
                    voltage_kv: float = 300.0, cs_mm: float = 2.7,
                    amplitude_contrast: float = 0.07, step_tol: float = 0.0,
                    value_tol: float = 0.0):
    """Refine one parameter block (a CSP mode) by masked gradient ascent."""
    xv = gather_2d_hermitian_batched(windows_f, mask_pts)
    return _refine_mode_xv(
        params, xv, window_centers, tilt_defocus, mask_pts, Fref,
        tilt_weights, valid, mode, n, pixel_size, iters, lr, reg_weight,
        voltage_kv, cs_mm, amplitude_contrast, step_tol=step_tol,
        value_tol=value_tol)


def _schedule_core(
    params, xv, window_centers, tilt_defocus, mask_pts, Fref,
    tilt_weights, valid, offsets_by_mode, spin_offsets, modes, n,
    pixel_size, iters_per_mode, lr, reg_weight, voltage_kv, cs_mm,
    amplitude_contrast, step_tol=0.0, value_tol=0.0,
):
    """One tilt-series' (or series batch's) whole mode schedule: optional
    spin ring, then per mode an optional grid search (csp_GS) followed by
    the gradient polish. Returns (params, mode scores (..., n_modes),
    per-particle scores (..., P))."""
    if spin_offsets is not None:
        params, _ = _grid_search_xv(
            params, xv, window_centers, tilt_defocus, mask_pts, Fref,
            tilt_weights, valid, spin_offsets, 1, n, pixel_size,
            voltage_kv, cs_mm, amplitude_contrast)
    scores = []
    for i, mode in enumerate(modes):
        off = offsets_by_mode[i] if offsets_by_mode is not None else None
        with span("csp.mode", {"mode": mode}):
            if off is not None:
                params, _ = _grid_search_xv(
                    params, xv, window_centers, tilt_defocus, mask_pts, Fref,
                    tilt_weights, valid, off, mode, n, pixel_size,
                    voltage_kv, cs_mm, amplitude_contrast)
            params, s = _refine_mode_xv(
                params, xv, window_centers, tilt_defocus, mask_pts, Fref,
                tilt_weights, valid, mode, n, pixel_size, iters_per_mode, lr,
                reg_weight, voltage_kv, cs_mm, amplitude_contrast,
                step_tol=step_tol, value_tol=value_tol)
        scores.append(s)
    lead = params.tilt_angles.shape[:-1]
    mode_scores = (torch.stack(scores, -1) if scores
                   else torch.zeros(lead + (0,), device=xv.device))
    with span("csp.scores"), torch.no_grad():
        # final per-particle CTF-weighted NCC (the SCORE column)
        ncc = _csp_ncc(params, xv, window_centers, tilt_defocus, mask_pts,
                       Fref, n, pixel_size, voltage_kv, cs_mm,
                       amplitude_contrast)
        w = tilt_weights[..., :, None] * valid
        pscores = (torch.sum(ncc * w, -2)
                   / torch.clamp(torch.sum(w, -2), min=1e-6))
    return params, mode_scores, pscores


def csp_refine_schedule(params: CspParams, xv, window_centers, tilt_defocus,
                        mask_pts, Fref, tilt_weights, valid, offsets_by_mode,
                        spin_offsets, modes: tuple, n: int, pixel_size: float,
                        iters_per_mode: int = 20, lr: float = 0.3,
                        reg_weight: float = 0.1, voltage_kv: float = 300.0,
                        cs_mm: float = 2.7, amplitude_contrast: float = 0.07,
                        step_tol: float = 0.0, value_tol: float = 0.0):
    """Single-series CSP pass (see _schedule_core)."""
    return _schedule_core(
        params, xv, window_centers, tilt_defocus, mask_pts, Fref,
        tilt_weights, valid, offsets_by_mode, spin_offsets, modes, n,
        pixel_size, iters_per_mode, lr, reg_weight, voltage_kv, cs_mm,
        amplitude_contrast, step_tol=step_tol, value_tol=value_tol)


def _csp_refine_batch_chunk(params_b, xv_b, window_centers_b, tilt_defocus_b,
                            mask_pts, Fref, tilt_weights_b, valid_b,
                            offsets_by_mode, spin_offsets, modes, n,
                            pixel_size, series_vmap=False, **kw):
    """A chunk of series (every input with a leading series axis) through
    the whole schedule: vectorized over the series (series_vmap) or one
    series after another."""
    if series_vmap:
        return _schedule_core(
            params_b, xv_b, window_centers_b, tilt_defocus_b, mask_pts,
            Fref, tilt_weights_b, valid_b, offsets_by_mode, spin_offsets,
            modes, n, pixel_size, **kw)
    outs = [
        _schedule_core(
            CspParams(*(leaf[s] for leaf in params_b)), xv_b[s],
            window_centers_b[s], tilt_defocus_b[s], mask_pts, Fref,
            tilt_weights_b[s], valid_b[s], offsets_by_mode, spin_offsets,
            modes, n, pixel_size, **kw)
        for s in range(int(valid_b.shape[0]))]
    return (CspParams(*(torch.stack(x) for x in zip(*(o[0] for o in outs)))),
            torch.stack([o[1] for o in outs]),
            torch.stack([o[2] for o in outs]))


@span("csp.refine_batch")
def csp_refine_batch(
    params_b: CspParams, xv_b, window_centers_b, tilt_defocus_b, mask_pts,
    Fref, tilt_weights_b, valid_b, offsets_by_mode, spin_offsets,
    modes: tuple, n: int, pixel_size: float, iters_per_mode: int = 20,
    lr: float = 0.3, reg_weight: float = 0.1, voltage_kv: float = 300.0,
    cs_mm: float = 2.7, amplitude_contrast: float = 0.07,
    step_tol: float = 0.0, value_tol: float = 0.0,
    series_per_dispatch: int = 2, series_vmap: bool = False,
):
    """Batched CSP: S tilt-series (padded to common (T, P) with valid=0
    rows) through the full mode schedule, on the device of the inputs.

    series_vmap=False refines the series one after another (one series'
    working set); series_vmap=True vectorizes them in chunks sized from the
    card's free memory (`rows_per_call`). series_per_dispatch only bounds
    the JAX package's dispatch length; here it changes nothing. Each
    series' result is the same either way: every step's normalization,
    termination and final choice is per series."""
    del series_per_dispatch
    kw = dict(iters_per_mode=iters_per_mode, lr=lr, reg_weight=reg_weight,
              voltage_kv=voltage_kv, cs_mm=cs_mm,
              amplitude_contrast=amplitude_contrast, step_tol=step_tol,
              value_tol=value_tol)
    S = int(valid_b.shape[0])
    if not series_vmap:
        return _csp_refine_batch_chunk(
            params_b, xv_b, window_centers_b, tilt_defocus_b, mask_pts, Fref,
            tilt_weights_b, valid_b, offsets_by_mode, spin_offsets, modes, n,
            pixel_size, series_vmap=False, **kw)
    # a series' step keeps ~40 float32 values per (T, P, G) point for the
    # gather, the NCC and their gradients
    chunk = rows_per_call(xv_b.device, S, 40 * 4 * xv_b[0].numel())
    outs = []
    for lo in range(0, S, chunk):
        sl = slice(lo, min(lo + chunk, S))
        outs.append(_csp_refine_batch_chunk(
            CspParams(*(leaf[sl] for leaf in params_b)), xv_b[sl],
            window_centers_b[sl], tilt_defocus_b[sl], mask_pts, Fref,
            tilt_weights_b[sl], valid_b[sl], offsets_by_mode, spin_offsets,
            modes, n, pixel_size, series_vmap=True, **kw))
    if len(outs) == 1:
        return outs[0]
    return (CspParams(*(torch.cat(x) for x in zip(*(o[0] for o in outs)))),
            torch.cat([o[1] for o in outs]), torch.cat([o[2] for o in outs]))


def window_centers_of(pred, shape, n: int):
    """Integer window centres for predicted positions (numpy (T, P, 2),
    centered): (ci (T, P, 2) int32 absolute, in-bounds (T, P) bool). Rounds
    half to even, as the JAX package's host code does."""
    ny, nx = shape
    center = np.array([ny // 2, nx // 2])
    ci = np.round(pred + center).astype(np.int32)
    inb = ((ci[..., 0] >= n // 2) & (ci[..., 0] < ny - n // 2)
           & (ci[..., 1] >= n // 2) & (ci[..., 1] < nx - n // 2))
    ci = np.clip(ci, n // 2, [ny - n // 2 - 1, nx - n // 2 - 1])
    return ci, inb


def cut_windows(tilt_images, ci, n: int):
    """(T, P, n, n) windows of (T, ny, nx) tilts at integer centres ci
    (T, P, 2) in one gather (the same clamp as window_particles)."""
    T, ny, nx = tilt_images.shape
    dev = tilt_images.device
    ci = torch.as_tensor(np.asarray(ci), device=dev).to(torch.int64)
    lim = torch.tensor([ny - n, nx - n], device=dev)
    starts = torch.minimum(torch.clamp(ci - n // 2, min=0), lim)
    ar = torch.arange(n, device=dev)
    y = (starts[..., 0, None] + ar)[..., :, None]
    x = (starts[..., 1, None] + ar)[..., None, :]
    t = torch.arange(T, device=dev).reshape(T, 1, 1, 1)
    return tilt_images[t, y, x]


def prepare_series_windows(tilt_images, params: CspParams, n: int, mask_pts,
                           device="cuda"):
    """Window every particle from every tilt at its predicted position and
    sample the window spectra at the mask points, on `device`.

    Returns (xv (T, P, G) complex, window_centers (T, P, 2) float32
    centered coords as numpy, valid (T, P) float32 numpy)."""
    dev = resolve_device(device)
    tilt_images = as_f32(tilt_images, dev)
    T, ny, nx = tilt_images.shape
    pred = project_positions(params).detach().cpu().numpy()
    ci, inb = window_centers_of(pred, (ny, nx), n)
    wins = cut_windows(tilt_images, ci, n)
    xv = gather_2d_hermitian_batched(image_to_fourier(wins),
                                     as_f32(mask_pts, dev))
    w_centers = (ci - np.array([ny // 2, nx // 2])).astype(np.float32)
    return xv, w_centers, inb.astype(np.float32)


def build_mode_offsets(modes, grid_tols, grid_steps: int = 9,
                       spin_step: float = 0.0, angle_step: float = 0.0,
                       shift_step: float = 0.0, random_iters: int = 0):
    """The candidate offsets of a mode schedule: (offsets_by_mode tuple
    aligned with modes, each (K, d) numpy or None; spin_offsets or None).

    angle_step / shift_step: explicit grid spacings, which set a mode's
    step count to ceil(2 tol / step) + 1 (clipped to 3..21) instead of
    grid_steps; random_iters adds random candidates within the tolerance."""

    def steps_for(m):
        sp = angle_step if m in (0, 1, 7, 4) else shift_step
        if m == 4:
            sp = 0.0  # defocus keeps the uniform count
        if sp and sp > 0 and grid_tols and m in grid_tols:
            t = float(np.max(np.atleast_1d(grid_tols[m])))
            return int(np.clip(round(2.0 * t / sp) + 1, 3, 21))
        return grid_steps

    offsets_by_mode = tuple(
        make_mode_offsets(m, grid_tols[m], steps_for(m),
                          random_iters=random_iters)
        if grid_tols and m in grid_tols and np.max(grid_tols[m]) > 0
        else None
        for m in modes
    )
    spin_offsets = (make_spin_offsets(spin_step)
                    if spin_step and spin_step > 0 else None)
    return offsets_by_mode, spin_offsets


def csp_refine(
    params: CspParams,
    tilt_images,         # (T, ny, nx) tilt series
    tilt_defocus,        # (T, 2)
    ref_volume,          # (n, n, n) current reference
    pixel_size: float,
    boxsize: int,
    modes=(0, 3, 1, 2),
    iters_per_mode: int = 20,
    lr: float = 0.3,
    low_res: float = 60.0,
    high_res: float = 12.0,
    reg_weight: float = 0.1,
    tilt_weights=None,
    voltage_kv: float = 300.0,
    cs_mm: float = 2.7,
    amplitude_contrast: float = 0.07,
    grid_tols: dict | None = None,
    grid_steps: int = 9,
    spin_step: float = 0.0,
    return_particle_scores: bool = False,
    angle_step: float = 0.0,
    shift_step: float = 0.0,
    random_iters: int = 0,
    step_tol: float = 0.0,
    value_tol: float = 0.0,
    device="cuda",
):
    """Full CSP pass on one tilt-series on `device`: extract windows at the
    predicted positions, then refine each mode's blocks in sequence.

    grid_tols: {mode: tolerance} — modes listed run a discrete search
    (csp_GS) before the gradient polish. spin_step > 0: an in-plane spin
    ring runs once before the schedule. Returns (params, mode scores) or,
    with return_particle_scores, also the per-particle scores (numpy)."""
    from pyp_tpu_torch.ops.fourier_slice import volume_to_fourier

    dev = resolve_device(device)
    params = CspParams(*(as_f32(x, dev) for x in params))
    tilt_images = as_f32(tilt_images, dev)
    T = tilt_images.shape[0]
    n = boxsize
    Fref = volume_to_fourier(as_f32(ref_volume, dev))
    mask_pts = as_f32(make_mask_points(n, pixel_size, low_res, high_res), dev)
    tilt_weights = (torch.ones(T, device=dev) if tilt_weights is None
                    else as_f32(tilt_weights, dev))
    xv, w_centers, valid = prepare_series_windows(
        tilt_images, params, n, mask_pts, device=dev)
    offsets_by_mode, spin_offsets = build_mode_offsets(
        modes, grid_tols, grid_steps, spin_step, angle_step=angle_step,
        shift_step=shift_step, random_iters=random_iters)
    params, mode_scores, pscores = csp_refine_schedule(
        params, xv, as_f32(w_centers, dev), as_f32(tilt_defocus, dev),
        mask_pts, Fref, tilt_weights, as_f32(valid, dev), offsets_by_mode,
        spin_offsets, tuple(modes), n, pixel_size,
        iters_per_mode=iters_per_mode, lr=lr, reg_weight=reg_weight,
        voltage_kv=voltage_kv, cs_mm=cs_mm,
        amplitude_contrast=amplitude_contrast,
        step_tol=step_tol, value_tol=value_tol)
    scores = [float(s) for s in mode_scores.cpu().numpy()]
    if not return_particle_scores:
        return params, scores
    return params, scores, pscores.cpu().numpy()


def csp_particles_for_reconstruction(params: CspParams, windows_f_shape=None):
    """Refined CSP params as per-(tilt, particle) reconstruction poses:
    (R_eff (T, P, 3, 3), image positions (T, P, 2), depth (T, P) px)."""
    return (effective_rotations(params), project_positions(params),
            particle_depth(params))
