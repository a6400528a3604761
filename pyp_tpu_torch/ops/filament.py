"""Filament segmentation and tracing (microtubules, actin, open membranes)
— the torch port of pyp_tpu/ops/filament.py (the MemBrain-Seg / TARDIS
roles, docs/guide/segmentation.rst "Open surfaces and filaments"):

1. **Tube enhancement** — Frangi vesselness from the scale-normalized
   Gaussian Hessian, computed spectrally: one rfftn of the tomogram, then
   each component H_ij = irfftn(-4 pi^2 k_i k_j G(k) F).
2. **Eigen-analysis** — closed-form (Cardano) eigenvalues of the
   symmetric 3x3 Hessian per voxel, sorted |l1| <= |l2| <= |l3|; the tube
   axis is the eigenvector of l1 via cross products of (H - l1 I) rows.
3. **Tracing** — greedy chaining of non-max-suppressed ridge points
   along the local axis (host side; the candidates are few).
4. **Particle sampling** — positions every `spacing` voxels along each
   traced filament with the local tangent as an orientation prior.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pyp_tpu_torch import as_f32, resolve_device


def _hessian_spectral(vol, sigma_px: float):
    """Scale-normalized Gaussian Hessian of a volume, computed in Fourier.

    Returns (nz, ny, nx, 6): Hzz, Hzy, Hzx, Hyy, Hyx, Hxx."""
    nz, ny, nx = vol.shape
    kw = dict(dtype=torch.float32, device=vol.device)
    F = torch.fft.rfftn(vol)
    kz = torch.fft.fftfreq(nz, **kw).reshape(nz, 1, 1)
    ky = torch.fft.fftfreq(ny, **kw).reshape(1, ny, 1)
    kx = torch.fft.rfftfreq(nx, **kw).reshape(1, 1, -1)
    g = torch.exp(-2.0 * (math.pi * sigma_px) ** 2 * (kz**2 + ky**2 + kx**2))
    # gamma = 2 scale normalization (Lindeberg): sigma^2 * d2/dx2
    base = -4.0 * math.pi**2 * sigma_px**2 * g * F
    comps = [torch.fft.irfftn(base * a * b, s=vol.shape)
             for a, b in ((kz, kz), (kz, ky), (kz, kx), (ky, ky), (ky, kx),
                          (kx, kx))]
    return torch.stack(comps, dim=-1)


def _eig3_symmetric(H):
    """Cardano eigenvalues of symmetric 3x3 fields (..., 6) ->
    (..., 3) sorted by |value| ascending."""
    hzz, hzy, hzx, hyy, hyx, hxx = (H[..., i] for i in range(6))
    q = (hzz + hyy + hxx) / 3.0
    azz, ayy, axx = hzz - q, hyy - q, hxx - q
    p2 = (azz**2 + ayy**2 + axx**2
          + 2.0 * (hzy**2 + hzx**2 + hyx**2))
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))
    # det of (A - q I) / p
    bzz, byy, bxx = azz / p, ayy / p, axx / p
    bzy, bzx, byx = hzy / p, hzx / p, hyx / p
    detB = (bzz * (byy * bxx - byx * byx)
            - bzy * (bzy * bxx - byx * bzx)
            + bzx * (bzy * byx - byy * bzx))
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    lam = torch.stack([e1, e2, e3], dim=-1)
    order = torch.argsort(torch.abs(lam), dim=-1, stable=True)
    return torch.gather(lam, -1, order)


def _axis_vector(H, lam1):
    """Eigenvector for eigenvalue lam1 of the symmetric Hessian (..., 6):
    the most stable cross product of two rows of (H - lam1 I). Returns
    unit (..., 3) as (z, y, x)."""
    hzz, hzy, hzx, hyy, hyx, hxx = (H[..., i] for i in range(6))
    r0 = torch.stack([hzz - lam1, hzy, hzx], -1)
    r1 = torch.stack([hzy, hyy - lam1, hyx], -1)
    r2 = torch.stack([hzx, hyx, hxx - lam1], -1)
    stack = torch.stack([torch.linalg.cross(r0, r1),
                         torch.linalg.cross(r0, r2),
                         torch.linalg.cross(r1, r2)], -2)   # (..., 3, 3)
    best = torch.argmax(torch.linalg.vector_norm(stack, dim=-1), dim=-1)
    v = torch.gather(stack, -2, best[..., None, None].expand(
        best.shape + (1, 3)))[..., 0, :]
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-12)


def _standardized(vol, dark, dev):
    v = as_f32(vol, dev)
    v = (v - v.mean()) / (v.std(correction=0) + 1e-6)
    return -v if dark else v  # bright structures internally


def vesselness(vol, sigma_px: float, alpha: float = 0.5, beta: float = 0.5,
               dark: bool = True, device="cuda"):
    """Frangi tube-likeness at one scale. Returns (V (nz, ny, nx),
    axis (nz, ny, nx, 3)) tensors. dark=True targets dark-on-bright tubes
    (cryo-ET density convention)."""
    dev = resolve_device(device)
    H = _hessian_spectral(_standardized(vol, dark, dev), sigma_px)
    lam = _eig3_symmetric(H)
    l1, l2, l3 = lam[..., 0], lam[..., 1], lam[..., 2]
    # bright tube: l2, l3 strongly negative, l1 ~ 0
    ra = torch.abs(l2) / (torch.abs(l3) + 1e-12)      # plate vs line
    rb = torch.abs(l1) / torch.sqrt(torch.abs(l2 * l3) + 1e-12)  # blob deviation
    s2 = l1**2 + l2**2 + l3**2
    c = 2.0 * torch.mean(torch.sqrt(s2))
    V = ((1.0 - torch.exp(-(ra**2) / (2 * alpha**2)))
         * torch.exp(-(rb**2) / (2 * beta**2))
         * (1.0 - torch.exp(-s2 / (2 * c**2 + 1e-12))))
    V = torch.where((l2 < 0) & (l3 < 0), V, 0.0)
    return V, _axis_vector(H, l1)


def sheetness(vol, sigma_px: float, beta: float = 0.5, dark: bool = True,
              device="cuda"):
    """Frangi-style plate-likeness at one scale (open membranes). Returns
    (S (nz, ny, nx), normal (nz, ny, nx, 3)): a bright plate has one
    strongly negative eigenvalue (l3), the membrane normal is its
    eigenvector."""
    dev = resolve_device(device)
    H = _hessian_spectral(_standardized(vol, dark, dev), sigma_px)
    lam = _eig3_symmetric(H)
    l1, l2, l3 = lam[..., 0], lam[..., 1], lam[..., 2]
    r_sheet = torch.abs(l2) / (torch.abs(l3) + 1e-12)
    s2 = l1**2 + l2**2 + l3**2
    c = 2.0 * torch.mean(torch.sqrt(s2))
    S = (torch.exp(-(r_sheet**2) / (2 * beta**2))
         * (1.0 - torch.exp(-s2 / (2 * c**2 + 1e-12))))
    S = torch.where(l3 < 0, S, 0.0)
    return S, _axis_vector(H, l3)


def segment_membranes(tomogram, thickness_px: float = 3.0,
                      threshold: float = 0.3, dark: bool = True,
                      device="cuda"):
    """Open-membrane segmentation: sheetness -> binary mask + per-voxel
    normals. Returns numpy (mask {0, 1} float32, sheet map, normals)."""
    S, normal = sheetness(tomogram, sigma_px=max(thickness_px / 2.0, 1.0),
                          dark=dark, device=device)
    mask = (S > threshold * S.max()).to(torch.float32)
    return mask.cpu().numpy(), S.cpu().numpy(), normal.cpu().numpy()


def trace_filaments(points, axes, scores, link_dist: float = 6.0,
                    max_angle_deg: float = 30.0, min_points: int = 4):
    """Greedy chaining of ridge points into filament polylines.

    points (N, 3) voxel coords (z, y, x); axes (N, 3) local tube axis;
    scores (N,). Grows each unused seed (best score first) in both
    directions, linking the nearest unused point within `link_dist` whose
    direction agrees within `max_angle_deg`. Returns a list of index
    arrays."""
    pts = np.asarray(points, dtype=np.float32)
    ax = np.asarray(axes, dtype=np.float32)
    sc = np.asarray(scores, dtype=np.float32)
    N = len(pts)
    used = np.zeros(N, dtype=bool)
    cosmax = np.cos(np.radians(max_angle_deg))
    order = np.argsort(-sc)
    filaments = []
    for seed in order:
        if used[seed]:
            continue
        chain = [seed]
        used[seed] = True
        for direction in (1.0, -1.0):
            cur = seed
            d = direction * ax[seed]
            while True:
                rel = pts - pts[cur]
                dist = np.linalg.norm(rel, axis=1)
                ahead = rel @ d
                okd = (~used) & (dist < link_dist) & (ahead > 0.3 * dist)
                # direction agreement (axis sign-invariant)
                cosang = np.abs(np.sum(ax * ax[cur], axis=1))
                ok = okd & (cosang > cosmax)
                if not ok.any():
                    break
                cand = np.where(ok)[0]
                nxt = cand[np.argmin(dist[cand])]
                used[nxt] = True
                if direction > 0:
                    chain.append(nxt)
                else:
                    chain.insert(0, nxt)
                step = pts[nxt] - pts[cur]
                d = step / (np.linalg.norm(step) + 1e-9)
                cur = nxt
        # short chains stay marked used: they are noise
        if len(chain) >= min_points:
            filaments.append(np.asarray(chain))
    return filaments


def pick_filaments(tomogram, radius_px, spacing_px: float,
                   threshold: float = 0.3, max_points: int = 4000,
                   dark: bool = True, min_points: int = 4, device="cuda"):
    """Full filament picking: vesselness -> ridge points -> traced
    polylines -> particles every `spacing_px` with tangent orientation
    priors. radius_px is a scalar or a (min, max) range (3 log-spaced
    sigmas, per-voxel max response with the winning scale's axis).

    Returns numpy (coords (N, 4) = (z, y, x, score), eulers (N, 3) tangent
    priors, fil_id (N,))."""
    from pyp_tpu_torch.core.geometry import normal_to_euler

    dev = resolve_device(device)
    radii = np.atleast_1d(np.asarray(radius_px, dtype=np.float32))
    if len(radii) == 1:
        sigmas = [max(float(radii[0]) / np.sqrt(2.0), 1.0)]
    else:
        sigmas = list(np.geomspace(max(radii.min() / np.sqrt(2.0), 1.0),
                                   max(radii.max() / np.sqrt(2.0), 1.0), 3))
    tomo = as_f32(tomogram, dev)
    V, axis = None, None
    for s in sigmas:
        Vs, axs = vesselness(tomo, sigma_px=float(s), dark=dark, device=dev)
        if V is None:
            V, axis = Vs, axs
        else:
            better = Vs > V
            V = torch.where(better, Vs, V)
            axis = torch.where(better[..., None], axs, axis)
    V, axis_np = V.cpu().numpy(), axis.cpu().numpy()
    radius_px = float(np.max(radii))
    # candidate ridge points: top responses above threshold, greedily
    # de-duplicated at half the linking distance
    thr = threshold * V.max()
    Vf = V.ravel()
    above = np.flatnonzero(Vf > thr)
    k = 4 * max_points
    if len(above) > k:   # partial select: no full-volume argsort
        above = above[np.argpartition(-Vf[above], k)[:k]]
    flat = above[np.argsort(-Vf[above])]
    cand = np.stack(np.unravel_index(flat, V.shape), 1).astype(np.float32)
    keep = []
    occupied = np.zeros(V.shape, dtype=bool)
    rr = max(int(round(radius_px)), 1)
    for i, c in enumerate(cand):
        iz, iy, ix = c.astype(int)
        if occupied[iz, iy, ix]:
            continue
        keep.append(i)
        z0, z1 = max(iz - rr, 0), iz + rr + 1
        y0, y1 = max(iy - rr, 0), iy + rr + 1
        x0, x1 = max(ix - rr, 0), ix + rr + 1
        occupied[z0:z1, y0:y1, x0:x1] = True
        if len(keep) >= max_points:
            break
    cand = cand[keep]
    idx = tuple(cand.astype(int).T)
    scores = V[idx]
    axes = axis_np[idx]

    filaments = trace_filaments(cand, axes, scores,
                                link_dist=max(3.0 * radius_px, 6.0),
                                min_points=min_points)
    coords, eulers, fil_id = [], [], []
    for fi, chain in enumerate(filaments):
        poly = cand[chain]
        # arc-length resampling every spacing_px
        seg = np.linalg.norm(np.diff(poly, axis=0), axis=1)
        arc = np.concatenate([[0.0], np.cumsum(seg)])
        if arc[-1] < spacing_px:
            samples = np.array([0.5 * arc[-1]])
        else:
            samples = np.arange(0.0, arc[-1] + 1e-6, spacing_px)
        for s in samples:
            k = min(np.searchsorted(arc, s), len(poly) - 1)
            k0 = max(k - 1, 0)
            t = ((s - arc[k0]) / max(arc[min(k0 + 1, len(arc) - 1)]
                                     - arc[k0], 1e-9)) if k > 0 else 0.0
            p = poly[k0] * (1 - t) + poly[min(k0 + 1, len(poly) - 1)] * t
            tan = (poly[min(k0 + 1, len(poly) - 1)] - poly[k0])
            tan = tan / (np.linalg.norm(tan) + 1e-9)    # (z, y, x)
            ph, th, ps = normal_to_euler(float(tan[2]), float(tan[1]),
                                         float(tan[0]))
            coords.append((*p, float(V[tuple(p.astype(int) % np.array(V.shape))])))
            eulers.append((float(ph), float(th), float(ps)))
            fil_id.append(fi)
    if not coords:
        return (np.zeros((0, 4), np.float32), np.zeros((0, 3), np.float32),
                np.zeros((0,), np.int32))
    return (np.asarray(coords, np.float32), np.asarray(eulers, np.float32),
            np.asarray(fil_id, np.int32))
