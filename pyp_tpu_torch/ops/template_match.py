"""Rigid alignment of two maps — the torch port of `rotate_volume` and
`align_volumes` of pyp_tpu/ops/template_match.py, which score an ab initio
map against a known one (its global orientation and hand are arbitrary).
The module's template matching and virion detection are not ported yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pyp_tpu_torch import as_f32, resolve_device
from pyp_tpu_torch.core.geometry import euler_to_matrix


def _trilinear_constant(vol, coords):
    """scipy/JAX `map_coordinates(order=1, mode="constant")` of a volume
    at (z, y, x) coordinates (3, ...): an explicit 8-tap gather in which
    each out-of-range tap counts zero on its own. Differentiable in the
    coordinates through the tap weights."""
    shape = vol.shape
    flat = vol.reshape(-1)
    lo = [torch.floor(c) for c in coords]
    fr = [c - f for c, f in zip(coords, lo)]
    lo = [f.to(torch.int64) for f in lo]
    out = None
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                idx, w, ok = [], None, None
                for ax, d in enumerate((dz, dy, dx)):
                    i = lo[ax] + d
                    wa = fr[ax] if d else 1.0 - fr[ax]
                    va = (i >= 0) & (i < shape[ax])
                    idx.append(torch.clamp(i, 0, shape[ax] - 1))
                    w = wa if w is None else w * wa
                    ok = va if ok is None else ok & va
                lin = (idx[0] * shape[1] + idx[1]) * shape[2] + idx[2]
                term = torch.where(ok, flat[lin], 0.0) * w
                out = term if out is None else out + term
    return out


def rotate_volume(vol, phi, theta, psi):
    """Rotate a cubic volume (tensor) by ZYZ Euler angles about its centre
    n//2 (trilinear, zero outside; out(v) = vol(R^T (v - c) + c)). The
    angles may be numbers or 0-dim tensors; differentiable in both."""
    n = vol.shape[-1]
    c = n // 2
    R = euler_to_matrix(phi, theta, psi).to(vol.device)
    ax = torch.arange(n, dtype=torch.float32, device=vol.device) - c
    zz, yy, xx = torch.meshgrid(ax, ax, ax, indexing="ij")
    pts = torch.stack([xx, yy, zz], dim=-1)               # xyz order
    src = torch.einsum("ij,abcj->abci", R.T, pts)         # R^T
    return _trilinear_constant(
        vol, (src[..., 2] + c, src[..., 1] + c, src[..., 0] + c))


def align_volumes(a, b, coarse_step: float = 30.0, iters: int = 60,
                  try_hand: bool = True, device="cuda"):
    """Rigidly align volume `a` to volume `b` over rotations (and the hand
    flip): a coarse ZYZ grid, then a gradient polish of the correlation
    through the trilinear resampler (torch.autograd.grad over the three
    angles). Returns (cc, (phi, theta, psi), flipped, aligned volume as
    numpy). The coarse grid's scores stay on the device until its first
    best (strict `>` in grid order) is read once."""
    dev = resolve_device(device)
    b_j = as_f32(np.ascontiguousarray(b), dev)
    b_c = b_j - b_j.mean()
    b_n = b_c / (torch.linalg.vector_norm(b_c) + 1e-8)

    def cc_of(vol_j, p, t, s):
        r = rotate_volume(vol_j, p, t, s)
        rc = r - r.mean()
        return (rc * b_n).sum() / (torch.linalg.vector_norm(rc) + 1e-8)

    def hand(flip):
        va = np.ascontiguousarray(np.asarray(a)[::-1] if flip else np.asarray(a))
        return as_f32(va, dev)

    hands = (False, True) if try_hand else (False,)
    grid, ccs = [], []
    with torch.no_grad():
        for flip in hands:
            va_j = hand(flip)
            for p in np.arange(0.0, 360.0, coarse_step):
                for t in np.arange(0.0, 181.0, coarse_step):
                    for s in np.arange(0.0, 360.0, coarse_step):
                        ccs.append(cc_of(va_j, float(p), float(t), float(s)))
                        grid.append(((float(p), float(t), float(s)), flip))
        ccs = torch.stack(ccs).cpu().numpy()
    # first best over the grid (the JAX loop's strict `>` from -2)
    i = int(np.argmax(ccs))
    best = (float(ccs[i]), grid[i][0], grid[i][1])
    flip = best[2]
    va_j = hand(flip)
    angles = torch.tensor(best[1], dtype=torch.float32, device=dev)
    m = torch.zeros(3, device=dev)
    for i in range(iters):
        ang = angles.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(cc_of(va_j, ang[0], ang[1], ang[2]), ang)
        gn = g / (torch.linalg.vector_norm(g) + 1e-9)
        m = 0.7 * m + gn
        decay = 0.5 * (1 + math.cos(math.pi * i / iters))
        angles = angles + 3.0 * decay * m
    with torch.no_grad():
        cc = float(cc_of(va_j, angles[0], angles[1], angles[2]))
        if cc < best[0]:
            angles = torch.tensor(best[1], dtype=torch.float32, device=dev)
            cc = best[0]
        aligned = rotate_volume(va_j, float(angles[0]), float(angles[1]),
                                float(angles[2])).cpu().numpy()
    return cc, tuple(float(x) for x in angles), flip, aligned
