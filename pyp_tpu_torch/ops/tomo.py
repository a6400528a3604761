"""Tilt-series alignment and tomogram reconstruction — the torch port of
pyp_tpu/ops/tomo.py:

  * `prealign_tilt_series` — cosine-stretch cross-correlation between
    adjacent tilts, accumulated outward from the zero-tilt image
    (tiltxcorr semantics); every adjacent pair is stretched and
    correlated in one batch and the shifts are read back once;
  * `track_patches` / `track_beads` — patch or gold-bead tracks across the
    series, every (tilt, patch) window in one batch;
  * `solve_projection_model` / `solve_projection_model_robust` — the
    single-axis projection model (per-tilt shifts, a global tilt-axis
    angle, 3D points), float64 numpy on the host as in the JAX package, so
    the same axis-angle grid point wins;
  * `wbp_reconstruct` — ramp-filtered weighted backprojection: each z slab
    gathers rows of the filtered tilts at x' = x cos(th) + z sin(th) for a
    block of tilts at once, blocks sized from the card's free memory
    (`rows_per_call`);
  * `sart_reconstruct` — ordered-subset SART/SIRT;
  * `ctf_correct_tilts` — strip-free phase flipping with the defocus
    gradient along the tilt direction, all defocus bands of a tilt in one
    batched inverse FFT;
  * `detect_handedness`, `ctf_deconvolve`.

Geometry: tilt angle theta rotates the specimen about the image y axis; a
voxel at centred coords (z, y, x) projects to image coords
(y, x cos(theta) + z sin(theta)).

The host-side results (shifts, tracks, projection models) are numpy
arrays; images and volumes are tensors on the device of the call. Unlike
the JAX package's, `wbp_reconstruct` returns exactly `thickness` slices:
the reference returns ceil(thickness / slab) * slab.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from pyp_tpu_torch import as_f32, resolve_device, rows_per_call
from pyp_tpu_torch.core import ctf as ctf_model
from pyp_tpu_torch.core.filters import apply_bandpass


def _chunks(total: int, per_row: int, dev):
    """Slices of range(total), each as many rows as `rows_per_call` lets
    take at per_row bytes a row."""
    n = rows_per_call(dev, total, per_row)
    return [slice(i, min(i + n, total)) for i in range(0, total, n)]


# ---------------------------------------------------------------------------
# pre-alignment (tiltxcorr)
# ---------------------------------------------------------------------------

def _xcorr_shift(a, b, bp_low=0.01, bp_high=0.25):
    """Shift of b relative to a via phase-weighted cross-correlation with
    parabolic sub-pixel refinement. Returns (..., 2) (dy, dx) such that
    shifting b by (dy, dx) aligns it to a."""
    from pyp_tpu_torch.ops.motion import _subpixel_peak

    ny, nx = a.shape[-2], a.shape[-1]
    A = torch.fft.rfft2(apply_bandpass(a, bp_low, bp_high))
    Bf = torch.fft.rfft2(apply_bandpass(b, bp_low, bp_high))
    cc = torch.fft.irfft2(A * torch.conj(Bf), s=(ny, nx))
    return _subpixel_peak(cc)


def _stretch_x(img, factor):
    """Stretch images (..., ny, nx) along x about their centre by `factor`
    (a number or a tensor broadcastable to the leading axes): linear
    interpolation in which each out-of-range tap counts zero on its own,
    as `map_coordinates(order=1, mode="constant")` does."""
    n = img.shape[-1]
    c = n // 2
    factor = torch.as_tensor(factor, dtype=torch.float32, device=img.device)
    xs = ((torch.arange(n, dtype=torch.float32, device=img.device) - c)
          / factor[..., None] + c)                       # (..., nx)
    x0f = torch.floor(xs)
    w1 = xs - x0f
    x0 = x0f.to(torch.int64)
    out = 0.0
    for i, w in ((x0, 1.0 - w1), (x0 + 1, w1)):
        ok = (i >= 0) & (i < n)
        idx = torch.clamp(i, 0, n - 1)
        idx = idx[..., None, :].expand(img.shape)
        tap = torch.gather(img, -1, idx)
        out = out + torch.where(ok[..., None, :], tap, 0.0) * w[..., None, :]
    return out


def prealign_tilt_series(tilts, tilt_angles, bp_low=0.01, bp_high=0.2,
                         device="cuda"):
    """tiltxcorr-equivalent: pairwise adjacent alignment, accumulated from
    the lowest-|angle| tilt outward.

    tilts: (T, ny, nx); tilt_angles: (T,) degrees (monotonic order).
    Returns shifts (T, 2) float32 numpy: shifting tilt t by shifts[t]
    aligns the series."""
    dev = resolve_device(device)
    tilts = as_f32(tilts, dev)
    angles = np.asarray(tilt_angles, dtype=np.float64)
    T, ny, nx = tilts.shape
    ref_idx = int(np.argmin(np.abs(angles)))

    order = [(t, t - 1) for t in range(ref_idx + 1, T)]
    order += [(t, t + 1) for t in range(ref_idx - 1, -1, -1)]
    rel = np.zeros((T, 2), dtype=np.float32)
    if order:
        cur = np.array([t for t, _ in order])
        prev = np.array([p for _, p in order])
        stretch = (np.cos(np.radians(angles[prev]))
                   / np.cos(np.radians(angles[cur])))
        stretch = torch.as_tensor(stretch.astype(np.float32), device=dev)
        found = []
        for s in _chunks(len(order), ny * nx * 4 * 12, dev):
            stretched = _stretch_x(tilts[cur[s]], stretch[s])
            # the pairs correlate in _xcorr_shift's own band, as in the JAX
            # package: bp_low and bp_high do not reach it
            found.append(_xcorr_shift(tilts[prev[s]], stretched))
        rel[cur] = torch.cat(found).cpu().numpy()

    shifts = np.zeros((T, 2), dtype=np.float32)
    for t in range(ref_idx + 1, T):
        shifts[t] = shifts[t - 1] + rel[t]
    for t in range(ref_idx - 1, -1, -1):
        shifts[t] = shifts[t + 1] + rel[t]
    return shifts


# ---------------------------------------------------------------------------
# patch tracking + projection-model solve (tiltalign)
# ---------------------------------------------------------------------------

def _windows(stack, tidx, coords, box: int):
    """box² windows of a (T, ny, nx) stack: window i is cut from tilt
    tidx[i] around integer coords[i] = (y, x), each shifted to lie inside
    the image (as `ops.extract.window_particles` does)."""
    _, ny, nx = stack.shape
    dev = stack.device
    lim = torch.tensor([ny - box, nx - box], device=dev)
    coords = torch.as_tensor(coords, device=dev).to(torch.int64)
    starts = torch.minimum(torch.clamp(coords - box // 2, min=0), lim)
    ar = torch.arange(box, device=dev)
    y = (starts[:, 0, None] + ar)[:, :, None]
    x = (starts[:, 1, None] + ar)[:, None, :]
    t = torch.as_tensor(tidx, device=dev).to(torch.int64)[:, None, None]
    return stack[t, y, x]


def _predicted(centers, shifts, angles, ref_idx, c):
    """Predicted (T, P, 2) positions of features defined on the reference
    tilt: x compresses by cos(theta) about the centre, and the series
    shift moves content by shifts[t], so a feature appears at -shift."""
    preds = []
    for t in range(len(angles)):
        cos_t = np.cos(np.radians(angles[t])) / np.cos(np.radians(angles[ref_idx]))
        pred = centers.copy()
        pred[:, 1] = (centers[:, 1] - c[1]) * cos_t + c[1]
        preds.append(pred - np.asarray(shifts[t]))
    return np.stack(preds)


def _taper(windows):
    """Windows minus their mean, rolled off to zero over their outer
    quarter by a cosine edge: the window's own borders, which do not move
    with its content, then do not pull the correlation peak to zero."""
    n = windows.shape[-1]
    r = torch.arange(n, dtype=torch.float32, device=windows.device)
    ramp = torch.clamp(torch.minimum(r + 0.5, n - 0.5 - r) / max(n // 4, 1),
                       max=1.0)
    w1 = 0.5 - 0.5 * torch.cos(math.pi * ramp)
    return ((windows - windows.mean(dim=(-2, -1), keepdim=True))
            * (w1[:, None] * w1[None, :]))


# How track_patches follows a patch: from tilt to tilt (True), or by
# correlating every tilt with the zero tilt as the JAX package does
# (False, set only by the tests that hold the tracker to the JAX one).
TILT_TO_TILT = True


def track_patches(tilts, shifts, tilt_angles, patch_centers,
                  patch_size: int = 64, device="cuda"):
    """Track patches (defined on the zero-tilt image) through the series.

    Returns measured positions (T, P, 2) float32 numpy, pixel coords (y, x)
    of each patch centre in each tilt.

    Each patch is followed from tilt to tilt outward from the zero tilt:
    the window of tilt t is stretched along x by cos(theta_prev) /
    cos(theta_t) about its centre and correlated with the previous tilt's
    window at the position measured there (P windows per step). The JAX
    package instead correlates every tilt's window, cut at the position
    the prealignment and a cos(theta) compression about the image centre
    predict, with the zero tilt's window (all T x P windows in one batch,
    `TILT_TO_TILT = False`); at high tilt that window is foreshortened and
    its content rearranged, and its tracks lose part of the in-plane
    rotation's y motion (ROADMAP Queue 3)."""
    dev = resolve_device(device)
    tilts = as_f32(tilts, dev)
    T, ny, nx = tilts.shape
    angles = np.asarray(tilt_angles, dtype=np.float64)
    ref_idx = int(np.argmin(np.abs(angles)))
    centers = np.asarray(patch_centers, dtype=np.float32)  # (P, 2) (y, x)
    P = len(centers)
    c = np.array([ny // 2, nx // 2], dtype=np.float32)
    shifts = np.asarray(shifts, dtype=np.float32)

    if TILT_TO_TILT:
        return _track_adjacent(tilts, shifts, angles, centers, patch_size,
                               ref_idx, c)
    ref_patches = _windows(tilts, np.full(P, ref_idx),
                           np.round(centers).astype(np.int64), patch_size)
    pred = _predicted(centers, shifts, angles, ref_idx, c)   # (T, P, 2)
    pr = np.round(pred)
    cur = _windows(tilts, np.repeat(np.arange(T), P),
                   pr.reshape(-1, 2).astype(np.int64), patch_size)
    a = ref_patches.repeat(T, 1, 1)
    d = torch.cat([_xcorr_shift(a[s], cur[s]) for s in
                   _chunks(T * P, patch_size ** 2 * 4 * 12, dev)])
    d = d.cpu().numpy().reshape(T, P, 2)
    return (pr - d).astype(np.float32)  # content found shifted by -d


def _track_adjacent(tilts, shifts, angles, centers, box, ref_idx, c,
                    refine: int = 8):
    """track_patches' tilt-to-tilt tracker: outward from the zero tilt, one step
    per tilt. The point followed is the one at the reference window's
    centre: a window is cut at the rounded measurement and the rounding
    is carried into the next step. Each step moves the window's content by
    the shift found so far and measures again, `refine` times."""
    from pyp_tpu_torch.core.fft import shift_images

    T = tilts.shape[0]
    P = len(centers)
    cosd = np.cos(np.radians(angles))
    measured = np.zeros((T, P, 2), dtype=np.float32)
    measured[ref_idx] = centers
    steps = [(t, t - 1) for t in range(ref_idx + 1, T)]
    steps += [(t, t + 1) for t in range(ref_idx - 1, -1, -1)]
    for t, prev in steps:
        m = measured[prev]
        mr = np.round(m)
        ref = _windows(tilts, np.full(P, prev), mr.astype(np.int64), box)
        f = np.float32(cosd[t] / cosd[prev])
        # the same point at tilt t: x compresses about the image centre,
        # and the series shift moves content by -(shift_t - shift_prev)
        pred = mr.copy()
        pred[:, 1] = (mr[:, 1] - c[1]) * f + c[1]
        pred = pred - (shifts[t] - shifts[prev])
        pr = np.round(pred)
        # a window twice the size: the content is moved by the estimate
        # so far and the central box cut again, since a tapered window's
        # correlation finds only part of a shift of its content
        big = _windows(tilts, np.full(P, t), pr.astype(np.int64), 2 * box)
        ref_t = _taper(ref)
        stretch = torch.full((P,), 1.0 / f, device=tilts.device)
        d = torch.zeros((P, 2), dtype=torch.float32, device=tilts.device)
        for _ in range(refine):
            cur = shift_images(big, d)[:, box // 2:box // 2 + box,
                                       box // 2:box // 2 + box]
            step = _xcorr_shift(ref_t, _taper(_stretch_x(cur, stretch)))
            d = d + step * torch.tensor([1.0, f], device=tilts.device)
        d = d.cpu().numpy()
        frac = m - mr
        frac[:, 1] *= f
        measured[t] = pr - d + frac
    return measured


class ProjectionModel(NamedTuple):
    shifts: np.ndarray       # (T, 2) per-tilt shifts (y, x)
    axis_angle: np.float32   # in-plane tilt-axis rotation (deg)
    points3d: np.ndarray     # (P, 3) fiducial/patch positions (z, y, x), centred
    residual: np.float32     # rms residual (pixels)


def solve_projection_model(measured, tilt_angles, image_shape, iters: int = 5):
    """Alternating least squares for the single-axis projection model:

        m(t, p) ~= Rz2(axis) @ [ y_p,  x_p cos(th_t) + z_p sin(th_t) ] - d_t

    (centred coords). Solves per-tilt shifts d_t, the global axis angle
    and the 3D points; float64 numpy on the host, as in the JAX package
    (`iters` is accepted for its signature; the solve is closed-form)."""
    m = np.asarray(measured, dtype=np.float64).copy()
    T, P, _ = m.shape
    ny, nx = image_shape
    center = np.array([ny // 2, nx // 2], dtype=np.float64)
    m -= center
    th = np.radians(np.asarray(tilt_angles, dtype=np.float64))

    A_x = np.stack([np.cos(th), np.sin(th)], axis=1)

    def project(pts, alpha, d):
        ca, sa = np.cos(np.radians(alpha)), np.sin(np.radians(alpha))
        xr = pts[None, :, 2] * np.cos(th)[:, None] + pts[None, :, 0] * np.sin(th)[:, None]
        yr = np.broadcast_to(pts[None, :, 1], (T, P)).copy()
        x2 = ca * xr - sa * yr
        y2 = sa * xr + ca * yr
        return np.stack([y2, x2], axis=-1) - d[:, None, :]

    def solve_given_alpha(alpha):
        """Closed-form inner solve at a fixed axis angle: centring the
        measurements over points cancels the per-tilt shifts (with the
        gauge mean(points) = 0), so the points come from one least-squares
        solve and the shifts from the mean residual."""
        ca, sa = np.cos(np.radians(alpha)), np.sin(np.radians(alpha))
        mc = m - m.mean(axis=1, keepdims=True)  # center over points: d cancels
        # un-rotate by R(-alpha): x = ca*mx + sa*my ; y = ca*my - sa*mx
        ym = ca * mc[..., 0] - sa * mc[..., 1]
        ym_x = ca * mc[..., 1] + sa * mc[..., 0]
        pts = np.zeros((P, 3))
        for p in range(P):
            sol, *_ = np.linalg.lstsq(A_x, ym_x[:, p], rcond=None)
            pts[p, 2], pts[p, 0] = sol
            pts[p, 1] = ym[:, p].mean()
        pts -= pts.mean(axis=0, keepdims=True)  # gauge: centered point cloud
        pred = project(pts, alpha, np.zeros((T, 2)))
        d = (pred - m).mean(axis=1)
        r = project(pts, alpha, d) - m
        return float(np.sqrt((r**2).mean())), pts, d

    best = (1e18, 0.0, None, None)
    for alpha in np.arange(-10.0, 10.01, 1.0):
        rms, pts, d = solve_given_alpha(alpha)
        if rms < best[0]:
            best = (rms, alpha, pts, d)
    for alpha in np.arange(best[1] - 1.0, best[1] + 1.01, 0.1):
        rms, pts, d = solve_given_alpha(alpha)
        if rms < best[0]:
            best = (rms, alpha, pts, d)
    rms, alpha, pts, d = best[0], best[1], best[2], best[3]
    return ProjectionModel(
        shifts=d.astype(np.float32),
        axis_angle=np.float32(alpha),
        points3d=pts.astype(np.float32),
        residual=np.float32(rms),
    )


# ---------------------------------------------------------------------------
# gold-fiducial tracking + robust projection solve
# ---------------------------------------------------------------------------

def _bead_template(box: int, radius_px: float, device=None):
    """Zero-mean dark Gaussian disk matching a gold bead's appearance."""
    c = box // 2
    yy, xx = np.meshgrid(
        np.arange(box, dtype=np.float32) - c,
        np.arange(box, dtype=np.float32) - c,
        indexing="ij",
    )
    t = -np.exp(-(yy**2 + xx**2) / (2.0 * (radius_px / 1.5) ** 2))
    t -= t.mean()
    return torch.as_tensor(t.astype(np.float32), device=device)


def track_beads(tilts, shifts, tilt_angles, bead_yx, bead_radius_px: float = 8.0,
                box: int | None = None, device="cuda"):
    """Track gold fiducials through the series by template matching.

    bead_yx: (P, 2) bead centres on the lowest-|angle| tilt (pixel coords).
    Returns (measured (T, P, 2) positions, confidence (T, P) normalized
    correlation peaks in [-1, 1]), float32 numpy. All T x P windows are
    matched in one batch."""
    from pyp_tpu_torch.ops.motion import _subpixel_peak

    dev = resolve_device(device)
    tilts = as_f32(tilts, dev)
    T, ny, nx = tilts.shape
    angles = np.asarray(tilt_angles, dtype=np.float64)
    ref_idx = int(np.argmin(np.abs(angles)))
    centers = np.asarray(bead_yx, dtype=np.float32)
    P = centers.shape[0]
    if box is None:
        box = int(max(32, 6 * bead_radius_px))
    tpl = _bead_template(box, bead_radius_px, dev)
    tpl_f = torch.conj(torch.fft.rfft2(tpl))
    tpl_ss = (tpl ** 2).sum()
    c = np.array([ny // 2, nx // 2], dtype=np.float32)

    def match(windows):
        W = windows - windows.mean(dim=(-2, -1), keepdim=True)
        cc = torch.fft.irfft2(torch.fft.rfft2(W) * tpl_f[None], s=(box, box))
        denom = torch.sqrt((W ** 2).sum(dim=(-2, -1)) * tpl_ss) + 1e-6
        return _subpixel_peak(cc), cc.amax(dim=(-2, -1)) / denom

    pred = _predicted(centers, np.asarray(shifts, dtype=np.float32), angles,
                      ref_idx, c)                              # (T, P, 2)
    ci = np.round(pred).astype(np.int32)
    wins = _windows(tilts, np.repeat(np.arange(T), P),
                    ci.reshape(-1, 2).astype(np.int64), box)
    ds, pks = [], []
    for s in _chunks(T * P, box * box * 4 * 12, dev):
        d, pk = match(wins[s])
        ds.append(d)
        pks.append(pk)
    d = torch.cat(ds).cpu().numpy().reshape(T, P, 2)
    conf = torch.cat(pks).cpu().numpy().reshape(T, P).astype(np.float32)
    half = box // 2
    # windows near an edge are shifted inside: the actual window centre
    ci_eff = np.clip(ci - half, 0, [ny - box, nx - box]) + half
    measured = (ci_eff + d).astype(np.float32)
    # beads predicted off the image can't be measured
    off = ((pred[..., 0] < 0) | (pred[..., 0] > ny - 1)
           | (pred[..., 1] < 0) | (pred[..., 1] > nx - 1))
    conf[off] = 0.0
    return measured, conf


def _solve_alpha_weighted(m, th, w, alpha, n_inner: int = 4):
    """Weighted inner solve of the single-axis projection model at fixed
    axis angle: alternate (points | shifts) weighted least squares. m is
    centered (T, P, 2); w (T, P) >= 0. Returns (weighted rms, points (P,3),
    shifts (T,2), per-measurement residual norms (T,P))."""
    T, P, _ = m.shape
    ca, sa = np.cos(np.radians(alpha)), np.sin(np.radians(alpha))
    A = np.stack([np.cos(th), np.sin(th)], axis=1)  # (T, 2)
    d = np.zeros((T, 2))
    pts = np.zeros((P, 3))
    pred = np.zeros_like(m)
    for _ in range(n_inner):
        my = m[..., 0] + d[:, None, 0]
        mx = m[..., 1] + d[:, None, 1]
        yprime = ca * my - sa * mx   # R(-alpha) applied to (m + d)
        xprime = ca * mx + sa * my
        for p in range(P):
            wp = w[:, p]
            ws = max(wp.sum(), 1e-9)
            Aw = A * wp[:, None]
            sol, *_ = np.linalg.lstsq(Aw, xprime[:, p] * wp, rcond=None)
            pts[p, 2], pts[p, 0] = sol
            pts[p, 1] = (yprime[:, p] * wp).sum() / ws
        # gauge: weighted point-cloud centroid at origin
        wc = np.maximum(w.sum(axis=0), 1e-9)
        pts -= (pts * wc[:, None]).sum(axis=0) / wc.sum()
        xr = pts[None, :, 2] * np.cos(th)[:, None] + pts[None, :, 0] * np.sin(th)[:, None]
        yr = np.broadcast_to(pts[None, :, 1], (T, P))
        pred = np.stack([sa * xr + ca * yr, ca * xr - sa * yr], axis=-1)
        wsum = np.maximum(w.sum(axis=1), 1e-9)
        d = ((pred - m) * w[..., None]).sum(axis=1) / wsum[:, None]
    r = pred - d[:, None, :] - m
    rn = np.sqrt((r**2).sum(axis=-1))
    rms = float(np.sqrt(((rn**2) * w).sum() / max(w.sum(), 1e-9)))
    return rms, pts, d, rn


def solve_projection_model_robust(measured, tilt_angles, image_shape,
                                  confidence=None, rounds: int = 3,
                                  tukey_factor: float = 1.0,
                                  fixed_alpha=None):
    """Projection-model solve with IRLS outlier rejection (tiltalign's
    robust fitting role): Tukey-biweight reweighting on top of the
    tracker's confidence, the axis angle grid-searched outside the
    weighted inner solve. Host float64 numpy. Returns (ProjectionModel,
    final weights (T, P) float32)."""
    m = np.asarray(measured, dtype=np.float64).copy()
    T, P, _ = m.shape
    ny, nx = image_shape
    m -= np.array([ny // 2, nx // 2], dtype=np.float64)
    th = np.radians(np.asarray(tilt_angles, dtype=np.float64))
    w0 = (
        np.clip(np.asarray(confidence, dtype=np.float64), 0.0, None)
        if confidence is not None else np.ones((T, P))
    )
    w = w0.copy()

    def best_alpha(w, coarse):
        if fixed_alpha is not None:
            # calibrated tilt axis: no axis search
            rms, *_ = _solve_alpha_weighted(m, th, w, float(fixed_alpha))
            return (rms, float(fixed_alpha))
        grid = (np.arange(-10.0, 10.01, 1.0) if coarse
                else np.arange(best[1] - 1.0, best[1] + 1.01, 0.1))
        out = (1e18, 0.0)
        for alpha in grid:
            rms, *_ = _solve_alpha_weighted(m, th, w, alpha)
            if rms < out[0]:
                out = (rms, alpha)
        return out

    best = best_alpha(w, coarse=True)
    best = best_alpha(w, coarse=False)
    rms, pts, d, rn = _solve_alpha_weighted(m, th, w, best[1])
    for _ in range(rounds):
        active = w > 1e-6
        sigma = 1.4826 * np.median(rn[active]) + 1e-6
        cthr = 4.685 * sigma * max(float(tukey_factor), 1e-3)
        wt = np.where(rn < cthr, (1.0 - (rn / cthr) ** 2) ** 2, 0.0)
        w = w0 * wt
        best = best_alpha(w, coarse=False)
        rms, pts, d, rn = _solve_alpha_weighted(m, th, w, best[1])
    # report the unweighted rms over surviving (inlier) measurements
    inl = w > 0.2 * np.maximum(w0, 1e-9)
    rms_in = float(np.sqrt((rn[inl] ** 2).mean())) if inl.any() else rms
    model = ProjectionModel(
        shifts=d.astype(np.float32),
        axis_angle=np.float32(best[1]),
        points3d=pts.astype(np.float32),
        residual=np.float32(rms_in),
    )
    return model, w.astype(np.float32)


def align_tilt_series_fiducial(tilts, tilt_angles, bead_radius_px: float = 8.0,
                               max_beads: int = 40, min_beads: int = 4,
                               tukey_factor: float = 1.0, fixed_alpha=None,
                               device="cuda"):
    """Gold-fiducial alignment: xcorr prealign -> bead detection on the
    zero-tilt image -> template tracking -> robust projection solve.

    Returns (ProjectionModel, bead coords (P, 2), tracks (T, P, 2),
    weights (T, P)), numpy. Raises ValueError when fewer than min_beads
    beads are found (the caller falls back to patch tracking)."""
    from pyp_tpu_torch.ops.pick import detect_gold_beads

    dev = resolve_device(device)
    tilts = as_f32(tilts, dev)
    T, ny, nx = tilts.shape
    angles = np.asarray(tilt_angles, dtype=np.float64)
    ref_idx = int(np.argmin(np.abs(angles)))

    shifts0 = prealign_tilt_series(tilts, angles, device=dev)
    picks = detect_gold_beads(
        tilts[ref_idx], bead_radius_px=int(round(bead_radius_px)),
        max_beads=max_beads, threshold_sigma=4.0, device=dev,
    )
    valid = picks.valid.cpu().numpy()
    coords = picks.coords.cpu().numpy()[valid].astype(np.float32)
    if coords.shape[0] < min_beads:
        raise ValueError(
            f"only {coords.shape[0]} gold beads found (need >= {min_beads})"
        )
    measured, conf = track_beads(
        tilts, shifts0, angles, coords, bead_radius_px=bead_radius_px,
        device=dev)
    model, w = solve_projection_model_robust(
        measured, angles, (ny, nx), confidence=conf,
        tukey_factor=tukey_factor, fixed_alpha=fixed_alpha,
    )
    return model, coords, measured, w


# ---------------------------------------------------------------------------
# weighted backprojection (the IMOD `tilt` equivalent)
# ---------------------------------------------------------------------------

def ramp_filter(nx: int, cutoff: float = 0.35, falloff: float = 0.05):
    """R-weighting along x: |f| up to cutoff, cosine rolloff after (IMOD
    -RADIAL semantics). (nx//2+1,) float32 tensor on the CPU."""
    f = np.abs(np.fft.rfftfreq(nx))
    w = np.where(f <= cutoff, f, 0.0)
    roll = (f > cutoff) & (f <= cutoff + falloff)
    w = np.where(roll, cutoff * 0.5 * (1 + np.cos(np.pi * (f - cutoff) / falloff)), w)
    w[0] = 0.25 / nx  # keep a small DC term so means survive
    return torch.from_numpy(w.astype(np.float32))


def fake_sirt_filter(nx: int, iterations: int, cutoff: float = 0.35,
                     falloff: float = 0.05):
    """Radial filter equivalent to `iterations` of SIRT (IMOD's
    -FakeSIRTiterations): Landweber iteration on the normal equations has
    per-frequency response 1 - (1 - mu/f)^k relative to the ramp."""
    f = np.abs(np.fft.rfftfreq(nx))
    ramp = ramp_filter(nx, cutoff, falloff).numpy()
    mu = max(f[1], 1.0 / (iterations + 1) * 0.5)
    conv = 1.0 - (1.0 - np.clip(mu / np.maximum(f, f[1]), 0.0, 1.0)) ** iterations
    w = ramp * conv
    w[0] = ramp[0]
    return torch.from_numpy(w.astype(np.float32))


def filter_window(nx: int, window: str):
    """Apodization atop the ramp (shepp-logan, hamming, hann; anything
    else is flat). (nx//2+1,) float32 tensor on the CPU."""
    f = np.abs(np.fft.rfftfreq(nx))  # 0..0.5
    if window == "shepp":
        w = np.sinc(f)  # sin(pi f)/(pi f)
    elif window == "hamming":
        w = 0.54 + 0.46 * np.cos(2 * np.pi * f)
    elif window == "hann":
        w = 0.5 * (1 + np.cos(2 * np.pi * f))
    else:
        w = np.ones_like(f)
    return torch.from_numpy(w.astype(np.float32))


def _filter_tilts(tilts, cutoff, falloff, fake_sirt: int = 0,
                  window: str = "none"):
    nx = tilts.shape[-1]
    if fake_sirt > 0:
        w = fake_sirt_filter(nx, fake_sirt, cutoff, falloff)
    else:
        w = ramp_filter(nx, cutoff, falloff)
    if window != "none":
        w = w * filter_window(nx, window)
    w = w.to(tilts.device)
    return torch.fft.irfft(torch.fft.rfft(tilts, dim=-1) * w, n=nx, dim=-1)


def _prepare(tilts, tilt_angles, shifts, dev):
    tilts = as_f32(tilts, dev)
    angles = torch.deg2rad(as_f32(tilt_angles, dev))
    if shifts is not None:
        from pyp_tpu_torch.core.fft import shift_images

        tilts = shift_images(tilts, as_f32(shifts, dev))
    return tilts, angles


def wbp_reconstruct(
    tilts, tilt_angles, shifts=None, thickness: int = 128,
    cutoff: float = 0.35, falloff: float = 0.05,
    tilt_weights=None, slab: int = 8, fake_sirt: int = 0,
    window: str = "none", z_shift: float = 0.0, device="cuda",
):
    """Weighted backprojection of an aligned tilt series.

    tilts: (T, ny, nx); tilt_angles (T,) degrees; shifts (T, 2) applied to
    the images before backprojection. Returns a (thickness, ny, nx) tensor
    with z centred (z = 0 at thickness//2).

    Ramp-filter along x, then for each block of z slices gather rows of
    the transposed filtered tilts (T, nx, ny) at x' = x cos(th) +
    z sin(th) for a block of tilts at once and sum over the tilts. The
    blocks take at most a quarter of the card's free memory (all at once
    on the CPU); `slab` is accepted for the JAX signature and does not
    change the result."""
    del slab
    dev = resolve_device(device)
    tilts, angles = _prepare(tilts, tilt_angles, shifts, dev)
    T, ny, nx = tilts.shape
    filt = _filter_tilts(tilts, cutoff, falloff, fake_sirt, window)
    if tilt_weights is not None:
        # (T,) exposure/cosine weights
        filt = filt * as_f32(tilt_weights, dev)[:, None, None]
    del tilts

    cx = nx // 2
    cz = thickness // 2 + z_shift  # +z_shift: volume slides up in z (IMOD SHIFT)
    xs = torch.arange(nx, dtype=torch.float32, device=dev) - cx
    filt_T = filt.transpose(1, 2).contiguous()  # (T, nx, ny): rows contiguous
    del filt
    cos_a, sin_a = torch.cos(angles), torch.sin(angles)

    # temporaries per (tilt, z): the two gathered (nx, ny) planes and
    # their weighted products
    pairs = rows_per_call(dev, T * thickness, nx * ny * 4 * 5)
    tb = min(T, pairs)
    zb = max(1, min(thickness, pairs // tb))
    out = torch.empty((thickness, ny, nx), dtype=torch.float32, device=dev)
    scale = math.pi / (2.0 * T)
    for z0 in range(0, thickness, zb):
        nz = min(zb, thickness - z0)
        zs = z0 + torch.arange(nz, dtype=torch.float32, device=dev) - cz
        acc = torch.zeros((nz, nx, ny), dtype=torch.float32, device=dev)
        for t0 in range(0, T, tb):
            t = torch.arange(t0, min(t0 + tb, T), device=dev)
            xprime = (xs[None, None, :] * cos_a[t, None, None]
                      + zs[None, :, None] * sin_a[t, None, None] + cx)
            xp = torch.clamp(xprime, 0.0, nx - 1.000001)
            x0 = torch.floor(xp)
            fx = xp - x0
            x0 = x0.to(torch.int64)
            inb = ((xprime >= 0) & (xprime <= nx - 1)).to(torch.float32)
            ti = t[:, None, None]
            v0 = filt_T[ti, x0]                               # (tb, nz, nx, ny)
            v1 = filt_T[ti, torch.clamp(x0 + 1, max=nx - 1)]
            acc += (v0 * ((1 - fx) * inb)[..., None]
                    + v1 * (fx * inb)[..., None]).sum(0)
            del v0, v1
        out[z0:z0 + nz] = acc.transpose(1, 2) * scale
    return out


def align_tilts(tilts, shifts, axis_angle: float = 0.0, device="cuda"):
    """Apply a projection model's alignment to a tilt series: shift each
    tilt by its aligning shift (a Fourier shift, as the backprojection's
    own) and turn it by the tilt-axis angle so the axis lies along y:
    aligned(p) = shifted(R(axis) p) about the image centre, bilinear with
    zero outside. Returns a (T, ny, nx) tensor."""
    from pyp_tpu_torch.core.fft import shift_images

    dev = resolve_device(device)
    tilts = as_f32(tilts, dev)
    if shifts is not None:
        tilts = shift_images(tilts, as_f32(shifts, dev))
    if not axis_angle:
        return tilts
    T, ny, nx = tilts.shape
    a = math.radians(float(axis_angle))
    ca, sa = math.cos(a), math.sin(a)
    y = (torch.arange(ny, dtype=torch.float32, device=dev) - ny // 2)[:, None]
    x = (torch.arange(nx, dtype=torch.float32, device=dev) - nx // 2)[None, :]
    sy = sa * x + ca * y + ny // 2
    sx = ca * x - sa * y + nx // 2
    y0f, x0f = torch.floor(sy), torch.floor(sx)
    fy, fx = sy - y0f, sx - x0f
    y0, x0 = y0f.to(torch.int64), x0f.to(torch.int64)
    flat = tilts.reshape(T, -1)
    out = torch.zeros_like(tilts)
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            yy, xx = y0 + dy, x0 + dx
            ok = (yy >= 0) & (yy < ny) & (xx >= 0) & (xx < nx)
            lin = (torch.clamp(yy, 0, ny - 1) * nx
                   + torch.clamp(xx, 0, nx - 1)).reshape(-1)
            tap = flat[:, lin].reshape(T, ny, nx)
            out += torch.where(ok, tap, 0.0) * (wy * wx)
    return out


def wbp_reconstruct_halves(tilts, tilt_angles, shifts=None,
                           thickness: int = 128, device="cuda", **kw):
    """Even/odd-tilt half tomograms (reference reconstruct_tomo_halves).
    Returns (half_even, half_odd) tensors."""
    dev = resolve_device(device)
    tilts = as_f32(tilts, dev)
    angles = as_f32(tilt_angles, dev)
    idx = np.arange(tilts.shape[0])
    halves = []
    for par in (0, 1):
        sel = torch.as_tensor(idx[idx % 2 == par], device=dev)
        sh = None if shifts is None else as_f32(shifts, dev)[sel]
        halves.append(wbp_reconstruct(tilts[sel], angles[sel], shifts=sh,
                                      thickness=thickness, device=dev, **kw))
    return halves[0], halves[1]


# ---------------------------------------------------------------------------
# per-tilt CTF correction (ctfphaseflip)
# ---------------------------------------------------------------------------

def ctf_correct_tilts(
    tilts, tilt_angles, defoci, pixel_size,
    voltage_kv=300.0, cs_mm=2.7, amplitude_contrast=0.07, axis_angle=0.0,
    n_bands: int = 20, device="cuda",
):
    """Phase-flip each tilt with the defocus gradient along the tilt
    direction (IMOD ctfphaseflip role): defocus(x) = df_t + x * pixel *
    tan(theta) (x from the tilt axis). Strip-free: the per-column defocus
    is rounded to `n_bands` bands; each tilt's spectrum is flipped with
    every band's CTF sign in one batched inverse FFT, and each column
    takes its band's result.

    defoci: (T,) nominal defocus (Å) at the tilt axis, per tilt."""
    dev = resolve_device(device)
    tilts = as_f32(tilts, dev)
    angles = as_f32(tilt_angles, dev)
    dfs = as_f32(defoci, dev)
    T, ny, nx = tilts.shape
    pixel_size = float(pixel_size)
    xs = (torch.arange(nx, dtype=torch.float32, device=dev) - nx // 2) * pixel_size
    nb = torch.arange(n_bands + 1, dtype=torch.float32, device=dev)
    bchunks = _chunks(n_bands, ny * nx * 4 * 4, dev)
    out = torch.empty_like(tilts)
    for i in range(T):
        theta = torch.deg2rad(angles[i])
        df_per_col = dfs[i] + xs * torch.tan(theta)           # (nx,)
        lo = df_per_col.min()
        hi = df_per_col.max() + 1.0
        edges = lo + (hi - lo) * nb / n_bands
        band_of_col = torch.clamp(
            ((df_per_col - lo) / (hi - lo) * n_bands).to(torch.int64),
            0, n_bands - 1)
        F = torch.fft.rfft2(tilts[i])
        for s in bchunks:
            df_mid = 0.5 * (edges[s] + edges[s.start + 1:s.stop + 1])
            c = ctf_model.ctf_2d((ny, nx), pixel_size, df_mid, df_mid, 0.0,
                                 float(voltage_kv), float(cs_mm),
                                 w=float(amplitude_contrast))
            flipped = torch.fft.irfft2(F * torch.sign(c), s=(ny, nx))
            sel = (band_of_col >= s.start) & (band_of_col < s.stop)
            j = torch.clamp(band_of_col - s.start, 0, s.stop - s.start - 1)
            pick = torch.gather(flipped, 0,
                                j[None, None, :].expand(1, ny, nx))[0]
            if s.start == 0:
                out[i] = torch.where(sel, pick, 0.0)
            else:
                out[i] = torch.where(sel, pick, out[i])
    return out


def _half_defoci(halves, defoci_rep, tile: int, pixel_size, voltage_kv,
                 cs_mm, w, df_range, df_step, min_res, max_res):
    """Per-half defocus estimate: (2K, ny, nxh) half-images -> (2K,) best
    defocus by correlating the background-normalized radial power profile
    with |CTF|^2 over a candidate grid centred on each half's nominal
    defocus."""
    from pyp_tpu_torch.ops.ctf_fit import (
        _gaussian_smooth_1d, _periodogram_pass, _radial_profile,
    )

    dev = halves.device
    n_bins = 192
    profiles = torch.stack([_radial_profile(_periodogram_pass(m, tile, 0, 0),
                                            n_bins) for m in halves])
    bg = torch.stack([_gaussian_smooth_1d(r, 6.0) for r in profiles])
    prof = profiles - bg
    g_bins = (torch.arange(n_bins, dtype=torch.float32, device=dev) + 0.5) / n_bins * 0.5
    g_phys = g_bins / pixel_size  # cycles/Å
    band = ((g_phys >= 1.0 / min_res) & (g_phys <= 1.0 / max_res)).to(prof.dtype)
    nband = torch.clamp(band.sum(), min=1.0)
    prof = prof * band[None]
    prof = prof - prof.sum(1, keepdim=True) / nband
    prof = prof * band[None]
    prof = prof / torch.sqrt(torch.sum(prof * prof, dim=1, keepdim=True) + 1e-12)

    deltas = torch.as_tensor(np.arange(-df_range, df_range + df_step, df_step,
                                       dtype=np.float32), device=dev)
    df_cand = defoci_rep[:, None] + deltas[None, :]             # (2K, D)
    c = ctf_model.ctf_1d(g_phys[None, None, :], df_cand[..., None],
                         voltage_kv, cs_mm, w)
    m = c * c * band[None, None, :]                             # (2K, D, R)
    m = m - (m.sum(-1, keepdim=True) / nband) * band
    m = m / torch.sqrt(torch.sum(m * m, dim=-1, keepdim=True) + 1e-12)
    scores = torch.einsum("br,bdr->bd", prof, m)                # (2K, D)
    best = torch.argmax(scores, dim=1)
    return torch.gather(df_cand, 1, best[:, None])[:, 0]


def detect_handedness(tilts, tilt_angles, defoci, pixel_size,
                      voltage_kv=300.0, cs_mm=2.7, w=0.07,
                      min_tilt: float = 20.0, df_range: float = 8000.0,
                      df_step: float = 250.0, max_tilt: float = 90.0,
                      device="cuda"):
    """Defocus handedness detection (ctf/core.py:1935): estimate defocus
    separately on the left and right halves of every tilt in
    [min_tilt, max_tilt]; the gradient across the tilt axis matches
    +tan(theta) for one hand and -tan(theta) for the other. Returns +1 or
    -1 and the per-tilt gradient measurements (numpy)."""
    dev = resolve_device(device)
    tilts = as_f32(tilts, dev)
    T, ny, nx = tilts.shape
    half = nx // 2
    angles = np.asarray(tilt_angles, dtype=np.float32)
    keep = (np.abs(angles) >= min_tilt) & (np.abs(angles) <= max_tilt)
    if not keep.any():
        return 0, np.array([])
    kept = tilts[torch.as_tensor(np.flatnonzero(keep), device=dev)]
    halves = torch.cat([kept[:, :, :half], kept[:, :, half:2 * half]])
    df_rep = torch.as_tensor(
        np.tile(np.asarray(defoci, np.float32)[keep], 2), device=dev)
    fits = _half_defoci(
        halves, df_rep, int(min(256, ny, half)), float(pixel_size),
        float(voltage_kv), float(cs_mm), float(w), float(df_range),
        float(df_step), 30.0, 8.0).cpu().numpy()
    K = int(keep.sum())
    measured = (fits[K:] - fits[:K]) / (half * pixel_size)  # d(df)/dx
    grads = measured * np.tan(np.radians(angles[keep]))
    return (1 if np.median(grads) > 0 else -1), np.asarray(grads)


# ---------------------------------------------------------------------------
# iterative reconstruction (SART / SIRT)
# ---------------------------------------------------------------------------

def _forward_project(vol, angle, nx: int):
    """Parallel-beam forward projection of (tz, ny, nx) about the y tilt
    axis — the adjoint of the WBP gather: proj[y, x'] integrates vol along
    the ray x = (x' - z sin) / cos; every z plane gathers at once."""
    tz, ny, _ = vol.shape
    dev = vol.device
    cx = nx // 2
    cz = tz // 2
    cos_t, sin_t = torch.cos(angle), torch.sin(angle)
    xs = torch.arange(nx, dtype=torch.float32, device=dev) - cx   # x' (detector)
    zs = torch.arange(tz, dtype=torch.float32, device=dev) - cz
    x_src = (xs[None, :] - zs[:, None] * sin_t) / cos_t + cx     # (tz, nx)
    xp = torch.clamp(x_src, 0.0, nx - 1.000001)
    x0 = torch.floor(xp)
    fx = xp - x0
    x0 = x0.to(torch.int64)
    v0 = torch.gather(vol, 2, x0[:, None, :].expand(tz, ny, nx))
    v1 = torch.gather(vol, 2, torch.clamp(x0 + 1, max=nx - 1)[:, None, :]
                      .expand(tz, ny, nx))
    vals = v0 * (1 - fx)[:, None, :] + v1 * fx[:, None, :]
    inb = ((x_src >= 0) & (x_src <= nx - 1)).to(vol.dtype)
    proj = (vals * inb[:, None, :]).sum(0)
    # 1/cos: ray path length per z sample
    return proj / torch.clamp(cos_t, min=0.2)


def _backproject_one(img, angle, thickness: int, ny: int, nx: int):
    """Unfiltered backprojection of one (ny, nx) image (the geometry of
    wbp_reconstruct's gather). Returns (thickness, ny, nx)."""
    dev = img.device
    cx = nx // 2
    cz = thickness // 2
    xs = torch.arange(nx, dtype=torch.float32, device=dev) - cx
    zs = torch.arange(thickness, dtype=torch.float32, device=dev) - cz
    xprime = xs[None, :] * torch.cos(angle) + zs[:, None] * torch.sin(angle) + cx
    xp = torch.clamp(xprime, 0.0, nx - 1.000001)
    x0 = torch.floor(xp)
    fx = xp - x0
    x0 = x0.to(torch.int64)
    v0 = img[:, x0]                                   # (ny, thickness, nx)
    v1 = img[:, torch.clamp(x0 + 1, max=nx - 1)]
    vals = v0 * (1 - fx)[None] + v1 * fx[None]
    inb = ((xprime >= 0) & (xprime <= nx - 1)).to(img.dtype)
    return vals.transpose(0, 1) * inb[:, None, :]


# SART's floor on a ray's length through the volume, in voxels (0, the JAX
# package's update, is set only by the tests that hold SART to it)
MIN_RAY_LENGTH = 1.0


def sart_reconstruct(
    tilts, tilt_angles, shifts=None, thickness: int = 128,
    iterations: int = 10, relax: float = 1.0, subsets: int = 4,
    tilt_weights=None, device="cuda",
):
    """SART/SIRT iterative tomogram reconstruction (the AreTomo `-Sart`
    option; `tomo_rec_method=sart`). Ordered-subset Landweber from zero:
    per angularly interleaved subset, forward-project the current volume
    along its tilts, backproject the ray-length-normalized residual,
    divide by the voxel ray count and take a relaxed step. Returns a
    (thickness, ny, nx) tensor.

    A ray's length through the volume is floored at `MIN_RAY_LENGTH`
    voxels: a ray that only clips a corner of the slab would otherwise
    carry its whole residual into a few voxels, which then grow without
    bound and spoil the interior (ROADMAP Queue 3)."""
    dev = resolve_device(device)
    tilts, angles = _prepare(tilts, tilt_angles, shifts, dev)
    T, ny, nx = tilts.shape
    if tilt_weights is not None:
        tilts = tilts * as_f32(tilt_weights, dev)[:, None, None]

    def bp_subset(imgs, angs):
        acc = torch.zeros((thickness, ny, nx), dtype=torch.float32, device=dev)
        for i in range(imgs.shape[0]):
            acc = acc + _backproject_one(imgs[i], angs[i], thickness, ny, nx)
        return acc

    def fp_subset(v, sub):
        return torch.stack([_forward_project(v, angles[i], nx) for i in sub])

    order = np.arange(T)
    subs = [order[s::subsets] for s in range(subsets)]
    # SIRT normalizations x += relax C A^T R (p - A x): R = 1/ray length
    # (forward projection of ones), C = 1/voxel ray count (backprojection
    # of ones)
    ones_vol = torch.ones((thickness, ny, nx), dtype=torch.float32, device=dev)
    raylen = [torch.clamp(fp_subset(ones_vol, sub), min=MIN_RAY_LENGTH)
              + 1e-3 for sub in subs]
    del ones_vol
    ones_img = torch.ones((ny, nx), dtype=torch.float32, device=dev)
    count = [bp_subset(ones_img.expand(len(sub), ny, nx), angles[sub]) + 1e-3
             for sub in subs]
    vol = torch.zeros((thickness, ny, nx), dtype=torch.float32, device=dev)
    for _ in range(iterations):
        for sub, rl, cnt in zip(subs, raylen, count):
            resid = (tilts[sub] - fp_subset(vol, sub)) / rl
            vol = vol + relax * (bp_subset(resid, angles[sub]) / cnt)
    return vol


# ---------------------------------------------------------------------------
# CTF deconvolution (IsoNet `deconv` / Warp deconvolution filter role)
# ---------------------------------------------------------------------------

def ctf_deconvolve(vol, defocus, pixel_size,
                   voltage_kv: float = 300.0, cs_mm: float = 2.7,
                   w: float = 0.07, snr_falloff: float = 1.0,
                   deconv_strength: float = 1.0,
                   highpass_nyquist: float = 0.02,
                   phase_flipped: bool = False, device="cuda"):
    """Wiener CTF deconvolution of a tomogram (nz, ny, nx) or one image
    (ny, nx): CTF(|g|) / (CTF^2 + 1/SSNR(|g|)) with an exponentially
    falling SSNR rolled off at DC by a cosine highpass, evaluated per rfft
    voxel between two FFTs. defocus: mean defocus in Å; phase_flipped: the
    input was already phase-flipped, so deconvolve with |CTF|."""
    dev = resolve_device(device)
    vol = as_f32(vol, dev)
    squeeze = vol.ndim == 2
    if squeeze:
        vol = vol[None]
    nz, ny, nx = vol.shape
    F = torch.fft.rfftn(vol)
    kw = dict(dtype=torch.float32, device=dev)
    gz = torch.fft.fftfreq(nz, **kw)[:, None, None]
    gy = torch.fft.fftfreq(ny, **kw)[None, :, None]
    gx = torch.fft.rfftfreq(nx, **kw)[None, None, :]
    # |g| as a fraction of Nyquist (cycles/px * 2)
    fnyq = 2.0 * torch.sqrt(gz * gz + gy * gy + gx * gx)
    g_abs = fnyq / (2.0 * pixel_size)  # cycles/Å for the CTF model
    c = ctf_model.ctf_1d(g_abs, torch.tensor(float(defocus), **kw),
                         float(voltage_kv), float(cs_mm), w=float(w))
    if phase_flipped:
        c = torch.abs(c)
    hp = 1.0 - torch.cos(torch.clamp(fnyq / highpass_nyquist, max=1.0) * math.pi)
    snr = (torch.exp(-100.0 * snr_falloff * fnyq / pixel_size)
           * (10.0 ** (3.0 * deconv_strength)) * hp)
    wiener = c / (c * c + 1.0 / torch.clamp(snr, min=1e-12))
    out = torch.fft.irfftn(F * wiener, s=(nz, ny, nx))
    return out[0] if squeeze else out
