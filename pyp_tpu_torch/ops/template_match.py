"""3D template matching, virion detection and rigid map alignment — the
torch port of pyp_tpu/ops/template_match.py:

  * `match_template_3d`: FFT-based locally-normalized cross-correlation
    of a rotated template over the tomogram, running max over a rotation
    grid (the reference's Correlation3DNew); `pick_peaks_3d`;
  * `detect_spheres` / `detect_spheres_template`: spherical-shell
    correlation over a radius sweep (the itkCLT Hough role);
  * `sphere_surface_points`, `match_on_surface`: surface-constrained
    picking with normal-aligned orientation priors;
  * `refine_virion_surface` / `refine_surface_sh`: membrane surfaces from
    a sphere seed, the second by gradient descent (torch.autograd) on
    spherical-harmonic coefficients;
  * `rotate_volume`, `align_volumes`: rigid alignment of two maps (an ab
    initio map against a known one, over rotation and hand).
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


def _trilinear_nearest(vol, coords):
    """`map_coordinates(order=1, mode="nearest")` of a volume at (z, y, x)
    coordinates (3, ...): each tap's index is clamped into the volume
    (not the coordinate), so the gradient in the coordinates is JAX's."""
    shape = vol.shape
    flat = vol.reshape(-1)
    lo = [torch.floor(c) for c in coords]
    fr = [c - f for c, f in zip(coords, lo)]
    lo = [f.to(torch.int64) for f in lo]
    out = None
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                idx, w = [], None
                for ax, d in enumerate((dz, dy, dx)):
                    idx.append(torch.clamp(lo[ax] + d, 0, shape[ax] - 1))
                    wa = fr[ax] if d else 1.0 - fr[ax]
                    w = wa if w is None else w * wa
                lin = (idx[0] * shape[1] + idx[1]) * shape[2] + idx[2]
                term = flat[lin] * w
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


# ---------------------------------------------------------------------------
# template matching and peak picking
# ---------------------------------------------------------------------------

def _box_mean(vol, k: int):
    """Mean over a (k, k, k) window with XLA's "SAME" zero padding ((k-1)//2
    before, k//2 after on each axis, so an even window works), as three
    separable 1-D passes."""
    lo, hi = (k - 1) // 2, k // 2
    v = vol[None, None]
    for ax in range(3):
        pad = [0, 0, 0, 0, 0, 0]
        pad[2 * (2 - ax)], pad[2 * (2 - ax) + 1] = lo, hi
        win = [1, 1, 1]
        win[ax] = k
        v = torch.nn.functional.avg_pool3d(
            torch.nn.functional.pad(v, pad), tuple(win), stride=1)
    return v[0, 0]


def _ncc_one_rotation(tomo_f, tomo, template, local_sd):
    """Correlation of one (already rotated) template with the tomogram via
    FFT, normalized by the template norm and the local tomogram sigma
    `local_sd` = sqrt(local variance + 1e-6)."""
    t = template - template.mean()
    tnorm = torch.sqrt((t * t).sum() + 1e-12)
    tz, ty, tx = t.shape
    # template at the origin, its centre rolled to index 0
    padded = torch.zeros_like(tomo)
    padded[:tz, :ty, :tx] = t
    padded = torch.roll(padded, (-(tz // 2), -(ty // 2), -(tx // 2)),
                        (0, 1, 2))
    cc = torch.fft.irfftn(tomo_f * torch.conj(torch.fft.rfftn(padded)),
                          s=tomo.shape)
    return cc / (tnorm * local_sd)


def match_template_3d(tomogram, template, angles, norm_size: int | None = None,
                      device="cuda"):
    """Locally-normalized 3D template matching over a rotation grid.

    tomogram: (nz, ny, nx); template: (t, t, t); angles: (A, 3) ZYZ
    degrees. Returns (best_score, best_angle_idx) tensors of the
    tomogram's shape; the first best rotation wins a tie."""
    dev = resolve_device(device)
    tomogram = as_f32(tomogram, dev)
    template = as_f32(template, dev)
    angles = np.asarray(angles, dtype=np.float32)
    if norm_size is None:
        norm_size = template.shape[-1]
    mu = _box_mean(tomogram, norm_size)
    var = _box_mean(tomogram * tomogram, norm_size) - mu * mu
    local_sd = torch.sqrt(torch.clamp(var, min=1e-6) * (norm_size ** 3) + 1e-6)
    del mu, var
    tomo_f = torch.fft.rfftn(tomogram)

    best = torch.full(tomogram.shape, -torch.inf, device=dev)
    best_idx = torch.zeros(tomogram.shape, dtype=torch.int32, device=dev)
    for a, (phi, theta, psi) in enumerate(angles):
        rot = rotate_volume(template, float(phi), float(theta), float(psi))
        cc = _ncc_one_rotation(tomo_f, tomogram, rot, local_sd)
        better = cc > best
        best = torch.where(better, cc, best)
        best_idx = torch.where(better, a, best_idx)
    return best, best_idx


def pick_peaks_3d(score, n_peaks: int, min_distance: int, threshold: float = 0.0):
    """Top-N local maxima of a 3D score volume (a tensor) with a distance
    constraint (an odd (2 d + 1)^3 max window). Returns (coords
    (n_peaks, 3) as (z, y, x), values, valid mask); rows past the last
    maximum have value -inf and valid False."""
    # the (k, k, k) window's maximum as three 1-D passes (the ends pad
    # with -inf)
    k = 2 * min_distance + 1
    mx = score[None, None]
    for win, pad in (((k, 1, 1), (min_distance, 0, 0)),
                     ((1, k, 1), (0, min_distance, 0)),
                     ((1, 1, k), (0, 0, min_distance))):
        mx = torch.nn.functional.max_pool3d(mx, win, stride=1, padding=pad)
    mx = mx[0, 0]
    cand = torch.where((score >= mx) & (score > threshold), score, -torch.inf)
    vals, idx = torch.topk(cand.reshape(-1), n_peaks)
    nz, ny, nx = score.shape
    coords = torch.stack([idx // (ny * nx), (idx // nx) % ny, idx % nx], dim=1)
    return coords, vals, torch.isfinite(vals)


def spherical_shell_template(radius_px: float, thickness_px: float = 2.0,
                             box: int | None = None, device=None):
    if box is None:
        box = int(2 * (radius_px + 3 * thickness_px) + 1)
    ax = np.arange(box) - box // 2
    r = np.sqrt(ax[:, None, None] ** 2 + ax[None, :, None] ** 2 + ax[None, None, :] ** 2)
    shell = np.exp(-0.5 * ((r - radius_px) / thickness_px) ** 2)
    return torch.as_tensor(shell.astype(np.float32), device=device)


def detect_spheres(tomogram, radii_px, n_peaks: int = 32, min_distance=None,
                   invert: bool = True, device="cuda"):
    """Virion/sphere detection: shell correlation over a radius sweep
    (Hough-transform equivalent of itkCLT). Returns (coords (N, 3),
    radii (N,), scores (N,), valid) tensors."""
    dev = resolve_device(device)
    tomo = as_f32(tomogram, dev)
    if invert:
        tomo = -tomo
    # a shell template larger than the tomogram cannot be correlated
    fit = [r for r in radii_px
           if int(2 * (float(r) + 6.0) + 1) <= min(tomo.shape)]
    if not fit:
        zeros = torch.zeros(n_peaks, device=dev)
        return (torch.zeros((n_peaks, 3), dtype=torch.int64, device=dev),
                zeros, zeros, torch.zeros(n_peaks, dtype=torch.bool, device=dev))
    best = torch.full(tomo.shape, -torch.inf, device=dev)
    best_r = torch.zeros(tomo.shape, device=dev)
    for r in fit:
        shell = spherical_shell_template(float(r), device=dev)
        score, _ = match_template_3d(tomo, shell, np.zeros((1, 3)),
                                     norm_size=shell.shape[0], device=dev)
        better = score > best
        best = torch.where(better, score, best)
        best_r = torch.where(better, float(r), best_r)
    if min_distance is None:
        min_distance = int(min(fit))
    coords, vals, valid = pick_peaks_3d(best, n_peaks, int(min_distance))
    radii = best_r[coords[:, 0], coords[:, 1], coords[:, 2]]
    return coords, radii, vals, valid


def detect_spheres_template(tomogram, radii_px, n_peaks: int = 32,
                            min_distance=None, device="cuda"):
    """tomo_vir_method=template: shell NCC against the raw densities (no
    contrast inversion)."""
    return detect_spheres(tomogram, radii_px, n_peaks, min_distance,
                          invert=False, device=device)


def sphere_surface_points(center, radius_px: float, n_points: int = 200):
    """Quasi-uniform points + outward normals on a sphere surface
    (Fibonacci lattice), numpy (z, y, x)."""
    idx = np.arange(n_points) + 0.5
    ga = np.pi * (1 + 5**0.5) * idx
    z = 1 - 2 * idx / n_points
    r = np.sqrt(1 - z * z)
    normals = np.stack([z, r * np.sin(ga), r * np.cos(ga)], axis=1)  # (z,y,x)
    points = np.asarray(center)[None, :] + radius_px * normals
    return points.astype(np.float32), normals.astype(np.float32)


def match_on_surface(tomogram, template, points, normals, psi_step: float = 30.0,
                     device="cuda"):
    """Score the template at surface points with its axis along the
    surface normal (in-plane spin searched; normals binned to 30° for one
    rotation per bin). Returns (scores (N,), best spin (N,)) tensors."""
    from pyp_tpu_torch.core.geometry import normal_to_euler
    from pyp_tpu_torch.ops.extract import subvolume_gather

    dev = resolve_device(device)
    tomo = as_f32(tomogram, dev)
    template = as_f32(template, dev)
    t = template.shape[-1]
    coords = torch.as_tensor(np.round(points).astype(np.int64), device=dev)
    subs = subvolume_gather(tomo, coords, t)  # (N, t, t, t)
    subs = subs - subs.mean(dim=(1, 2, 3), keepdim=True)
    snorm = torch.sqrt((subs * subs).sum(dim=(1, 2, 3)) + 1e-12)

    nrm = np.asarray(normals, dtype=np.float32)
    # the azimuth of the rotated z axis is psi in the ZYZ convention; phi
    # is the free spin about the template's own axis, searched here
    _, theta_n, azim_n = normal_to_euler(nrm[:, 2], nrm[:, 1], nrm[:, 0])
    key = np.round(np.stack([azim_n.numpy(), theta_n.numpy()], 1) / 30.0) * 30.0
    bins = np.unique(key, axis=0)
    best = torch.full((coords.shape[0],), -torch.inf, device=dev)
    best_psi = torch.zeros(coords.shape[0], device=dev)
    for psi in np.arange(0.0, 360.0, psi_step, dtype=np.float32):
        for azim_b, theta_b in bins:
            sel = torch.as_tensor((key[:, 0] == azim_b) & (key[:, 1] == theta_b),
                                  device=dev)
            rot = rotate_volume(template, float(psi), float(theta_b),
                                float(azim_b))
            rot = rot - rot.mean()
            rnorm = torch.sqrt((rot * rot).sum() + 1e-12)
            cc = (subs * rot[None]).sum(dim=(1, 2, 3)) / (snorm * rnorm)
            cc = torch.where(sel, cc, -torch.inf)
            better = cc > best
            best = torch.where(better, cc, best)
            best_psi = torch.where(better, float(psi), best_psi)
    return best, best_psi


def refine_virion_surface(tomogram, center, radius_px, n_points: int = 300,
                          search: float = 0.3, n_radial: int = 31,
                          dark_membrane: bool = True, smooth_iters: int = 2,
                          device="cuda"):
    """Refine a virion's membrane surface from a sphere seed (the
    level-set role of virus_segment_membrane): cast rays along Fibonacci
    directions, take the membrane density extremum within
    radius*(1 +/- search) on each ray, smooth the radii over surface
    neighbours. Returns numpy (points (N, 3) (z, y, x), normals, radii)."""
    dev = resolve_device(device)
    tomo = as_f32(tomogram, dev)
    center = np.asarray(center, dtype=np.float32)
    _, normals = sphere_surface_points(center, 1.0, n_points)  # unit dirs
    rs = np.linspace(radius_px * (1 - search), radius_px * (1 + search), n_radial)
    # sample the tomogram along every ray
    pts = center[None, None, :] + rs[None, :, None] * normals[:, None, :]
    coords = [as_f32(pts[..., i], dev) for i in range(3)]
    profiles = _trilinear_nearest(tomo, coords).cpu().numpy()  # (N, n_radial)
    idx = np.argmin(profiles, axis=1) if dark_membrane else np.argmax(profiles, axis=1)
    radii = rs[idx]
    # smooth radii over nearest surface neighbors
    for _ in range(smooth_iters):
        d = normals @ normals.T
        nn = np.argsort(-d, axis=1)[:, 1:7]  # 6 nearest directions
        radii = 0.5 * radii + 0.5 * radii[nn].mean(axis=1)
    points = center[None, :] + radii[:, None] * normals
    return points.astype(np.float32), normals, radii.astype(np.float32)


def _sh_basis(normals, l_max: int):
    """Real spherical-harmonics basis (N, (l_max+1)^2) at unit directions
    (z, y, x), plus per-coefficient l(l+1) curvature weights (numpy)."""
    from scipy.special import sph_harm_y

    z, y, x = normals[:, 0], normals[:, 1], normals[:, 2]
    theta = np.arccos(np.clip(z, -1.0, 1.0))
    phi = np.arctan2(y, x)
    cols, curv = [], []
    for l in range(l_max + 1):
        for m in range(-l, l + 1):
            ylm = sph_harm_y(l, abs(m), theta, phi)
            if m < 0:
                col = np.sqrt(2.0) * ylm.imag
            elif m == 0:
                col = ylm.real
            else:
                col = np.sqrt(2.0) * ylm.real
            cols.append(col)
            curv.append(float(l * (l + 1)))
    return (np.stack(cols, axis=1).astype(np.float32),
            np.asarray(curv, dtype=np.float32))


def refine_surface_sh(tomogram, center, radius_px, n_points: int = 400,
                      search: float = 0.3, l_max: int = 6,
                      dark_membrane: bool = True, iters: int = 80,
                      smoothness: float = 0.05, lr: float = 0.3,
                      n_radial: int = 31, device="cuda"):
    """Closed-surface refinement: the radius field over the sphere is a
    real spherical-harmonic series up to degree `l_max`, its coefficients
    descend (torch.autograd; momentum on the normalized gradient) to put
    the surface on the membrane density (trilinear samples of the
    standardized tomogram) under an l(l+1) curvature penalty, from the
    median ray-cast radius. Returns numpy (points (N, 3) (z, y, x),
    normals (N, 3), radii (N,))."""
    dev = resolve_device(device)
    raw = as_f32(tomogram, dev)
    tomo = (raw - raw.mean()) / (raw.std(correction=0) + 1e-8)
    center_np = np.asarray(center, dtype=np.float32)
    center_t = torch.as_tensor(center_np, device=dev)
    _, normals = sphere_surface_points(np.zeros(3), 1.0, n_points)
    Y, curv = _sh_basis(normals, l_max)
    _, _, radii0 = refine_virion_surface(
        raw, center_np, radius_px, n_points=n_points, search=search,
        n_radial=n_radial, smooth_iters=0, device=dev)
    r0 = float(np.median(radii0))
    Yt = torch.as_tensor(Y, device=dev)
    nt = torch.as_tensor(normals, device=dev)
    curvt = torch.as_tensor(curv, device=dev)
    sign = 1.0 if dark_membrane else -1.0
    lo = torch.tensor(radius_px * (1 - search), dtype=torch.float32, device=dev)
    hi = torch.tensor(radius_px * (1 + search), dtype=torch.float32, device=dev)

    def radii_of(c):
        # jnp.clip's gradient: half at a bound, as torch.maximum/minimum
        return torch.minimum(torch.maximum(r0 + Yt @ c, lo), hi)

    def loss(c):
        pts = center_t[None, :] + radii_of(c)[:, None] * nt
        vals = _trilinear_nearest(tomo, (pts[:, 0], pts[:, 1], pts[:, 2]))
        return sign * vals.mean() + smoothness * (curvt * c * c).mean() / max(
            radius_px, 1.0)

    c = torch.zeros(Y.shape[1], dtype=torch.float32, device=dev)
    m = torch.zeros_like(c)
    for _ in range(iters):
        cg = c.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(loss(cg), cg)
        m = 0.9 * m + g
        c = c - lr * m / (torch.linalg.vector_norm(g) + 1e-8)
    radii = radii_of(c).cpu().numpy()
    points = center_np[None, :] + radii[:, None] * normals
    return points.astype(np.float32), normals, radii.astype(np.float32)
