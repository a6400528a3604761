"""Trajectory regularization: smoothing of per-frame / per-tilt parameter
tracks.

Equivalent of the reference's analysis/fit.py family (fit_spline_
trajectory_1D :122, regularize/regularize_image :873/:235) — the smoothing
that stabilizes per-frame CSP/movie refinement. Three layers:

  * variance-weighted smoothing splines: frames whose local residual
    variance is high (outliers — a failed per-frame NCC fit) get LOW spline
    weight, so one bad frame cannot drag the trajectory (the reference's
    1/sqrt(local variance) spline weights);
  * angular tracks smoothed in tanh space (the reference's "AB1" method):
    bounded transform keeps an outlier angle from dominating the spline;
  * optional spatial coupling across particles (csp_spatial_sigma,
    pyp_config.toml:6480): beam-induced motion is locally coherent, so each
    particle's track is averaged with Gaussian-weighted neighbours.
"""

from __future__ import annotations

import numpy as np
from scipy.interpolate import UnivariateSpline
from scipy.ndimage import convolve1d


def _local_variance_weights(values, sigma: float = 3.0):
    """Spline weights from the local residual variance: w = 1/sqrt(var)
    (high local variance = unreliable frame = low weight)."""
    n = len(values)
    half = max(int(sigma), 1)
    t = np.arange(-3 * half, 3 * half + 1)
    b = np.exp(-0.5 * (t / sigma) ** 2)
    b /= b.sum()
    avg = convolve1d(values, b, mode="nearest")
    var = convolve1d((values - avg) ** 2, b, mode="nearest")
    if var.max() < 1e6 * np.finfo(float).eps:
        return None  # effectively noiseless: no reweighting needed
    return 1.0 / np.sqrt(np.maximum(var, 1e-12))


def fit_spline_trajectory(values, smoothing: float | None = None, k: int = 3,
                          factor: float = 1.0, outlier_mads: float = 0.0):
    """Smooth a 1-D trajectory (n_frames,) with a variance-weighted
    smoothing spline; returns the smoothed values on the same grid.

    Weights are 1/sigma_local (local residual std), so the chi²-calibrated
    smoothing target s = n * factor fits down to the local noise level but
    no further; frames with inflated local variance (outliers) get low
    weight. outlier_mads > 0 adds a rejection pass: frames whose residual
    to the first spline exceeds `outlier_mads` x MAD are dropped to
    near-zero weight and the spline refit — the defense the plain Gaussian
    smoother lacks (it averages outliers IN instead of out)."""
    values = np.asarray(values, dtype=np.float64)
    n = len(values)
    kk = min(k, n - 1)
    if n <= k + 1 or np.abs(values).sum() == 0:
        return values.copy()
    t = np.arange(n, dtype=np.float64)
    if smoothing is not None:
        return UnivariateSpline(t, values, k=kk, s=smoothing)(t)
    w = _local_variance_weights(values)
    if w is None:
        return values.copy()  # effectively noiseless
    s = n * float(factor)     # E[sum((r/sigma)^2)] = n at the noise floor
    spl = UnivariateSpline(t, values, k=kk, w=w, s=s)
    fit = spl(t)
    if outlier_mads > 0:
        # replace-and-refit (2 IRLS rounds): outlier frames take the
        # current spline value, the refit uses the robust global sigma
        # (1.4826 MAD) so the chi² target stays calibrated
        for _ in range(2):
            resid = np.abs(values - fit)
            mad = np.median(resid) + 1e-12
            bad = resid > outlier_mads * mad
            if not bad.any() or (~bad).sum() <= kk + 1:
                break
            cleaned = np.where(bad, fit, values)
            sig = 1.4826 * mad
            fit = UnivariateSpline(
                t, cleaned, k=kk, w=np.full(n, 1.0 / max(sig, 1e-6)),
                s=s)(t)
    return fit


def fit_angular_trajectory(degrees, k: int = 3, factor: float = 1.0,
                           outlier_mads: float = 0.0):
    """Angle track smoothing in tanh space (reference "AB1",
    analysis/fit.py:341): tanh bounds large excursions so an outlier angle
    can't dominate the least-squares spline; inverse-transform restores
    degrees."""
    d = np.radians(np.asarray(degrees, dtype=np.float64))
    tr = np.tanh(d)
    sm = fit_spline_trajectory(tr, k=k, factor=factor,
                               outlier_mads=outlier_mads)
    return np.degrees(np.arctanh(np.clip(sm, -1 + 1e-9, 1 - 1e-9)))


def regularize_trajectories(tracks, positions=None, time_sigma: float = 21.0,
                            spatial_sigma: float = 500.0,
                            method: str = "spline",
                            outlier_mads: float = 5.0,
                            angular: bool = False):
    """Regularize per-particle trajectories (P, T, D).

    method "spline": variance-weighted smoothing spline with outlier
    rejection per (particle, dim) — the production default (the reference's
    csp_transreg_method spline/XD family). method "gaussian": the round-2
    Gaussian kernel (kept for A/B; fails under heavy outliers).
    positions (P, 2 or 3) enables the spatial Gaussian coupling.
    angular=True routes through the tanh-space angle smoother."""
    tracks = np.asarray(tracks, dtype=np.float64)
    P, T, D = tracks.shape

    if method == "spline" and T > 4:
        smoothed = np.empty_like(tracks)
        for p in range(P):
            for d in range(D):
                if angular:
                    smoothed[p, :, d] = fit_angular_trajectory(
                        tracks[p, :, d], outlier_mads=outlier_mads)
                else:
                    smoothed[p, :, d] = fit_spline_trajectory(
                        tracks[p, :, d], outlier_mads=outlier_mads)
    else:
        t = np.arange(T)
        w = np.exp(-0.5 * ((t[:, None] - t[None, :])
                           / max(time_sigma, 1e-3)) ** 2)
        w /= w.sum(axis=1, keepdims=True)
        smoothed = np.einsum("ts,psd->ptd", w, tracks)

    if positions is not None and P > 1 and spatial_sigma > 0:
        pos = np.asarray(positions, dtype=np.float64)
        d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
        sw = np.exp(-0.5 * d2 / max(spatial_sigma, 1e-3) ** 2)
        sw /= sw.sum(axis=1, keepdims=True)
        smoothed = np.einsum("pq,qtd->ptd", sw, smoothed)
    return smoothed
