"""CTF estimation from micrograph power spectra (CTFFIND4/5 equivalent) —
the torch port of pyp_tpu/ops/ctf_fit.py.

  1. tiled periodogram: overlapping tiles -> batched rFFT -> mean power;
  2. background removal via Gaussian smoothing of the radial profile;
  3. the spectrum is resampled once to polar coordinates P(g, theta); the
     astigmatic model CTF^2(g; df(theta)) is separable in azimuth, so scoring
     a (df, astig, angle, phase) candidate is a batch of 1-D correlations —
     the whole search grid is evaluated as one matmul instead of
     materializing 2-D model spectra;
  4. coarse global grid -> two rounds of local grid refinement;
  5. outputs df1/df2/angast/phase/CC plus a CTFFIND-style goodness-of-fit
     resolution (correlation per shell crossing 0.3) and 1-D avgrot profiles.

Every search stage keeps its argmax on the device: a fit brings its six
numbers to the host only when the caller reads them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from pyp_tpu_torch import as_f32, resolve_device
from pyp_tpu_torch.core import ctf as ctf_model


class CtfFit(NamedTuple):
    df1: torch.Tensor        # Å (df1 >= df2)
    df2: torch.Tensor        # Å
    angast: torch.Tensor     # degrees
    phase_shift: torch.Tensor  # radians
    cc: torch.Tensor         # correlation score of the best fit
    fit_res: torch.Tensor    # Å: resolution to which the fit holds (CC_shell > 0.3)


def _periodogram_pass(micrograph, tile: int, oy: int, ox: int):
    """Mean tile power for one tiling offset — the tiles are one reshape of
    the micrograph and one batched FFT."""
    ny, nx = micrograph.shape
    gy, gx = (ny - oy) // tile, (nx - ox) // tile
    sub = micrograph[oy:oy + gy * tile, ox:ox + gx * tile]
    tiles = sub.reshape(gy, tile, gx, tile).permute(0, 2, 1, 3)
    tiles = tiles.reshape(gy * gx, tile, tile)
    tiles = tiles - tiles.mean(dim=(1, 2), keepdim=True)
    return (torch.fft.rfft2(tiles).abs() ** 2).mean(dim=0)


def periodogram(micrograph, tile: int = 512, overlap: float = 0.5):
    """Average power spectrum over (half-)overlapping tiles:
    (tile, tile//2+1). Two reshape-tiled passes offset by tile/2 give the
    50%-overlap average as batched FFTs. micrograph: a 2D tensor; the
    result is on its device."""
    ny, nx = micrograph.shape
    if ny < tile or nx < tile:
        return _periodogram_pass(micrograph, min(ny, nx), 0, 0)
    acc = _periodogram_pass(micrograph, tile, 0, 0)
    n_pass = 1
    if overlap > 0 and ny >= tile * 3 // 2 and nx >= tile * 3 // 2:
        acc = acc + _periodogram_pass(micrograph, tile, tile // 2, tile // 2)
        n_pass += 1
    return acc / n_pass


def _radial_profile(power, n_bins):
    ny, nxf = power.shape
    nx = (nxf - 1) * 2
    fy = np.fft.fftfreq(ny).reshape(ny, 1)
    fx = np.fft.rfftfreq(nx).reshape(1, nxf)
    r = np.sqrt(fy ** 2 + fx ** 2)
    bins = torch.from_numpy(np.clip((r / 0.5 * n_bins).astype(np.int64), 0,
                                    n_bins - 1).reshape(-1)).to(power.device)
    counts = torch.zeros(n_bins, device=power.device).index_add_(
        0, bins, torch.ones(bins.shape, device=power.device))
    sums = torch.zeros(n_bins, device=power.device).index_add_(
        0, bins, power.reshape(-1).to(torch.float32))
    return sums / torch.clamp(counts, min=1.0)


def _gaussian_smooth_1d(x, sigma):
    """Gaussian smoothing of a 1-D tensor with edge-replicated ends."""
    n = int(max(3, round(sigma * 6)) | 1)
    k = np.exp(-0.5 * ((np.arange(n) - n // 2) / sigma) ** 2)
    k = torch.from_numpy(k / k.sum()).to(device=x.device, dtype=x.dtype)
    xp = F.pad(x[None, None], (n // 2, n // 2), mode="replicate")
    return F.conv1d(xp, k[None, None])[0, 0]


def polar_resample(power, n_g: int = 256, n_theta: int = 64, g_max: float = 0.5):
    """Bilinear resample of an rfft-layout power spectrum to polar (g, theta).

    theta spans [0, pi) (Friedel symmetry); g in cycles/pixel up to g_max.
    Returns (P_polar (n_g, n_theta), g_axis (n_g,), theta_axis (n_theta,)).
    """
    ny, nxf = power.shape
    nx = (nxf - 1) * 2
    dev = power.device
    g = torch.linspace(0.0, g_max, n_g, device=dev)
    th = torch.arange(n_theta, device=dev, dtype=torch.float32) * (np.pi / n_theta)
    gy = g[:, None] * torch.sin(th)[None, :]
    gx = g[:, None] * torch.cos(th)[None, :]
    # map to rfft grid indices; gx >= 0 always since theta in [0, pi) maps
    # negative gx to the Friedel mate (-gx, -gy)
    neg = gx < 0
    gx = torch.where(neg, -gx, gx)
    gy = torch.where(neg, -gy, gy)
    iy = gy * ny  # cycles/pixel * n = index in fft layout (fractional)
    ix = gx * nx
    iy = torch.where(iy < 0, iy + ny, iy)
    y0 = torch.floor(iy).to(torch.int64)
    x0 = torch.floor(ix).to(torch.int64)
    wy = iy - y0
    wx = ix - x0
    y1 = (y0 + 1) % ny
    x1 = torch.clamp(x0 + 1, max=nxf - 1)
    y0 = y0 % ny
    x0 = torch.clamp(x0, max=nxf - 1)
    P = (
        power[y0, x0] * (1 - wy) * (1 - wx)
        + power[y1, x0] * wy * (1 - wx)
        + power[y0, x1] * (1 - wy) * wx
        + power[y1, x1] * wy * wx
    )
    return P, g, th


def _normalize_spectrum(P_polar, g_axis, bg_sigma: float = 6.0):
    """Subtract a smooth radial background and variance-normalize per ring."""
    radial = P_polar.mean(dim=1)
    bg = _gaussian_smooth_1d(radial, bg_sigma)
    P = P_polar - bg[:, None]
    # per-ring scale: robust against steep low-freq falloff
    scale = torch.sqrt((P * P).mean(dim=1, keepdim=True) + 1e-12)
    return P / scale


def _amp_phase(w: float) -> float:
    return math.atan2(w, math.sqrt(max(1.0 - w * w, 0.0)))


def _band_center(c2, ring_mask, dim):
    """Subtract the mean over the masked radial band (along `dim`) and zero
    the rings outside it."""
    band_mean = (c2 * ring_mask).sum(dim=dim, keepdim=True) / torch.clamp(
        ring_mask.sum(dim=dim, keepdim=True), min=1.0)
    return (c2 - band_mean) * ring_mask


def _model_polar(g_axis, theta_axis, df_mean, astig, angast_rad, phase,
                 pixel_size, voltage_kv, cs_mm, w, ring_mask=None):
    """CTF^2, zero-mean per ring, unit norm within the fit annulus, for a
    batch of parameter tuples. Returns (B, n_g, n_theta)."""
    g = g_axis[None, :, None] / pixel_size  # 1/Å
    df = df_mean[:, None, None] + astig[:, None, None] * torch.cos(
        2.0 * (theta_axis[None, None, :] - angast_rad[:, None, None])
    )
    x = ctf_model.chi(g, df, voltage_kv, cs_mm, phase[:, None, None])
    c2 = torch.sin(x + _amp_phase(w)) ** 2
    # center over the radial fit band per azimuth (NOT over azimuth — that
    # would null the model entirely at zero astigmatism)
    if ring_mask is not None:
        c2 = _band_center(c2, ring_mask[None, :, None], 1)
    norm = torch.sqrt((c2 * c2).mean(dim=(1, 2), keepdim=True) + 1e-12)
    return c2 / norm


def _score_chunk_rows(n_g: int, n_theta: int, device) -> int:
    """Parameter rows scored at once: 256 on the CPU; on a card, what a
    quarter of the free memory holds at ~12 float32 temporaries of one
    (n_g, n_theta) model per row."""
    if torch.device(device).type != "cuda":
        return 256
    free, _ = torch.cuda.mem_get_info(device)
    return int(max(64, (free // 4) // (12 * 4 * n_g * n_theta)))


def _score_grid(P_norm, g_axis, theta_axis, ring_mask, params,
                pixel_size, voltage_kv, cs_mm, w, chunk=None, model_fn=None):
    """NCC score for each (df_mean, astig, angast, phase) row of `params`
    (with `model_fn`, each row of whatever that model takes)."""
    Pm = _band_center(P_norm, ring_mask[:, None], 0).reshape(-1)
    chunk = chunk or _score_chunk_rows(*P_norm.shape, P_norm.device)
    if model_fn is None:
        def model_fn(p):
            return _model_polar(
                g_axis, theta_axis, p[:, 0], p[:, 1], p[:, 2], p[:, 3],
                pixel_size, voltage_kv, cs_mm, w, ring_mask)
    return torch.cat([
        model_fn(params[lo:lo + chunk]).reshape(-1, Pm.numel()) @ Pm
        for lo in range(0, params.shape[0], chunk)])


def _grid(*axes):
    """Rows of the cartesian product of 1-D tensors, first axis slowest."""
    return torch.stack([x.reshape(-1) for x in
                        torch.meshgrid(*axes, indexing="ij")], dim=1)


def fit_ctf(
    power,
    pixel_size: float,
    voltage_kv: float = 300.0,
    cs_mm: float = 2.7,
    amplitude_contrast: float = 0.07,
    dfmin: float = 3000.0,
    dfmax: float = 50000.0,
    dfstep: float = 200.0,
    min_res: float = 30.0,
    max_res: float = 5.0,
    fit_astigmatism: bool = True,
    max_astig: float = 4000.0,
    fit_phase: bool = False,
    n_g: int = 384,
    n_theta: int = 64,
    lowres_1d: float = 8.0,
    phase_min: float = 0.0,
    phase_max: float = 3.1416,
    phase_steps: int = 14,
    bg_sigma: float = 6.0,
    known_astig: float | None = None,
    known_astig_angle: float = 0.0,
    device="cuda",
) -> CtfFit:
    """Fit CTF parameters to an averaged power spectrum (rfft layout).

    known_astig/known_astig_angle (Å / deg): pin astigmatism to calibrated
    values and fit only defocus/phase (reference ctf tab known_ast /
    known_ast_angle; ctffind --known-astigmatism role). The fit's fields
    are 0-dim tensors on `device`."""
    dev = resolve_device(device)
    power = as_f32(power, dev)
    P_polar, g_axis, theta_axis = polar_resample(power, n_g, n_theta)
    P_norm = _normalize_spectrum(P_polar, g_axis, bg_sigma=bg_sigma)
    g_inv_a = g_axis / pixel_size
    ring_mask = ((g_inv_a > 1.0 / min_res) & (g_inv_a < 1.0 / max_res)).to(P_norm.dtype)
    kw = dict(device=dev, dtype=torch.float32)
    zero1 = torch.zeros(1, **kw)

    def linspace(lo, hi, n, endpoint=True):
        return torch.as_tensor(
            np.linspace(lo, hi, n, endpoint=endpoint).astype(np.float32),
            device=dev)

    w = amplitude_contrast

    def score(mask, params):
        return _score_grid(P_norm, g_axis, theta_axis, mask, params,
                           pixel_size, voltage_kv, cs_mm, w)

    # ---- stage 1: 1D exhaustive defocus scan (no astig) -------------------
    # restricted to a low-resolution sub-band: with astigmatism present the
    # azimuth-averaged rings dephase at high frequency, so a full-band 1D
    # score is misleading (same reason ctffind's 1D stage is band-limited)
    lowres_cut = max(max_res, lowres_1d)
    mask1 = ((g_inv_a > 1.0 / min_res) & (g_inv_a < 1.0 / lowres_cut)).to(P_norm.dtype)
    n_df = int(max(2, round((dfmax - dfmin) / dfstep)))
    dfs = linspace(dfmin, dfmax, n_df)
    ph1 = (linspace(phase_min, phase_max, phase_steps, endpoint=False)
           if fit_phase else zero1)
    g1 = _grid(dfs, ph1)
    dd, pp = g1[:, 0], g1[:, 1]
    params1 = torch.stack([dd, torch.zeros_like(dd), torch.zeros_like(dd), pp], dim=1)
    ibest = torch.argmax(score(mask1, params1))
    df_best = dd[ibest]
    phase_best = pp[ibest]

    # ---- stage 2: astig grid around best defocus --------------------------
    d_offsets = linspace(-6.0 * dfstep, 6.0 * dfstep, 13)
    if known_astig is not None:
        # pinned astigmatism: search defocus only, astig/angle fixed
        ka = torch.full_like(d_offsets, float(known_astig) / 2.0)
        kt = torch.full_like(d_offsets, float(np.radians(float(known_astig_angle))))
        params2 = torch.stack(
            [df_best + d_offsets, ka, kt,
             phase_best.expand_as(d_offsets)], dim=1)
        best2 = params2[torch.argmax(score(ring_mask, params2))]
        fit_astigmatism = False  # stage 3 keeps a/t frozen
    elif fit_astigmatism:
        astigs = linspace(0.0, max_astig, 11)
        angs = linspace(0.0, np.pi, 12, endpoint=False)
        phases = linspace(-0.25, 0.25, 3) if fit_phase else zero1
        grid = _grid(d_offsets, astigs, angs, phases)
        params2 = torch.stack(
            [df_best + grid[:, 0], grid[:, 1], grid[:, 2], phase_best + grid[:, 3]], dim=1
        )
        best2 = params2[torch.argmax(score(ring_mask, params2))]
    else:
        best2 = torch.stack([df_best, zero1[0], zero1[0], phase_best])

    # ---- stage 3: two rounds of local refinement --------------------------
    best = best2
    astig_free = known_astig is None
    for shrink in (0.25, 0.06):
        d_off = linspace(-dfstep * 4 * shrink, dfstep * 4 * shrink, 7)
        a_off = (linspace(-max_astig * 0.2 * shrink * 4,
                          max_astig * 0.2 * shrink * 4, 7)
                 if astig_free else zero1)
        t_off = (linspace(-np.pi / 12 * shrink * 4,
                          np.pi / 12 * shrink * 4, 7)
                 if astig_free else zero1)
        p_off = linspace(-0.3, 0.3, 5) if fit_phase else zero1
        grid = _grid(d_off, a_off, t_off, p_off)
        cand = torch.stack(
            [
                best[0] + grid[:, 0],
                torch.clamp(best[1] + grid[:, 1], min=0.0),
                best[2] + grid[:, 2],
                torch.clamp(best[3] + grid[:, 3], 0.0, np.pi),
            ],
            dim=1,
        )
        sc = score(ring_mask, cand)
        i = torch.argmax(sc)
        best = cand[i]
        best_score = sc[i]

    df_mean, astig, angast_rad, phase = best[0], best[1], best[2], best[3]
    df1 = df_mean + astig
    df2 = df_mean - astig
    angast_deg = torch.rad2deg(torch.remainder(angast_rad, np.pi))

    # ---- goodness-of-fit resolution ---------------------------------------
    # sliding radial-window correlation between data and fitted model
    # (ctffind-style "fit quality vs resolution")
    model = _model_polar(
        g_axis, theta_axis, df_mean[None], astig[None], angast_rad[None],
        phase[None], pixel_size, voltage_kv, cs_mm, w, ring_mask,
    )[0]
    Pc = _band_center(P_norm, ring_mask[:, None], 0)
    win = 9
    kern = torch.full((1, 1, win), 1.0 / win, **kw)

    def smooth_g(x):  # moving average along g for each azimuth, zero ends
        return F.conv1d(x.T[:, None, :], kern, padding=win // 2)[:, 0, :].T

    num = smooth_g(Pc * model).sum(dim=1)
    den = torch.sqrt(
        smooth_g(Pc * Pc).sum(dim=1) * smooth_g(model * model).sum(dim=1) + 1e-12
    )
    ring_cc_s = _gaussian_smooth_1d(num / den, 3.0)
    good = (ring_cc_s > 0.3) & (ring_mask > 0)
    # highest frequency bin that is still good
    idx = torch.where(good, torch.arange(n_g, device=dev), 0).max()
    fit_res = pixel_size / torch.clamp(g_axis[idx], min=1e-6)

    return CtfFit(
        df1=df1, df2=df2, angast=angast_deg, phase_shift=phase,
        cc=best_score, fit_res=fit_res,
    )


def fit_ctf_micrograph(micrograph, pixel_size, tile: int = 512,
                       tile_overlap: float = 0.5, device="cuda",
                       **kw) -> CtfFit:
    """Periodogram averaging + fit, end-to-end for one micrograph."""
    dev = resolve_device(device)
    power = periodogram(as_f32(micrograph, dev), tile=tile,
                        overlap=tile_overlap)
    return fit_ctf(power, pixel_size, device=dev, **kw)


def fit_ctf_tilt_series(tilt_images, pixel_size, device="cuda", **kw):
    """Per-tilt CTF fits (the reference's ctffind_tilt path): each tilt
    image gets its own periodogram + fit; the result's fields are (n_tilts,)
    tensors."""
    dev = resolve_device(device)
    fits = [fit_ctf_micrograph(tilt_images[i], pixel_size, device=dev, **kw)
            for i in range(tilt_images.shape[0])]
    return CtfFit(*(torch.stack([f[k] for f in fits])
                    for k in range(len(CtfFit._fields))))


def avgrot(power, pixel_size, fit: CtfFit, voltage_kv=300.0, cs_mm=2.7, w=0.07, n_bins=256):
    """CTFFIND-style _avgrot table: (g, radial average, normalized average,
    fitted CTF^2) as numpy arrays for plotting / .ctf output."""
    P_polar, g_axis, theta_axis = polar_resample(power, n_bins, 64)
    radial = P_polar.mean(dim=1)
    P_norm = _normalize_spectrum(P_polar, g_axis)
    norm_radial = P_norm.mean(dim=1)
    df_mean = 0.5 * (fit.df1 + fit.df2)
    model = ctf_model.ctf_1d(
        g_axis / pixel_size, df_mean, voltage_kv, cs_mm, w, fit.phase_shift
    ) ** 2
    table = torch.stack([g_axis / pixel_size, radial, norm_radial, model])
    return tuple(table.cpu().numpy())


def fit_ctf_local(micrograph, pixel_size, grid=(2, 2), tile: int = 512,
                  device="cuda", **kw):
    """Per-region CTF fits + defocus plane fit.

    Equivalent of the reference's quadrant/local defocus estimation: the
    micrograph is split into a grid of regions, each fit independently; a
    plane df(x, y) is least-squares fit through the per-region means for
    per-particle defocus interpolation.

    Returns (fits: list[CtfFit] row-major, plane: (3,) [df0, ddf/dy, ddf/dx]
    in Å and Å/px)."""
    dev = resolve_device(device)
    mic = as_f32(micrograph, dev)
    ny, nx = mic.shape
    gy, gx = grid
    fits = []
    centers = []
    for iy in range(gy):
        for ix in range(gx):
            sub = mic[iy * ny // gy:(iy + 1) * ny // gy,
                      ix * nx // gx:(ix + 1) * nx // gx]
            t = min(tile, min(sub.shape))
            fits.append(fit_ctf_micrograph(sub, pixel_size, tile=t,
                                           device=dev, **kw))
            centers.append(((iy + 0.5) * ny / gy, (ix + 0.5) * nx / gx))
    dfs = (0.5 * torch.stack([f.df1 + f.df2 for f in fits])
           ).cpu().numpy().astype(np.float64)
    # center the design matrix: with collinear region centers (e.g. a 1x2
    # grid) the raw lstsq min-norm solution leaks the CONSTANT defocus into
    # the degenerate gradient column; centering maps it cleanly to df0 and
    # zeroes the unconstrained direction instead
    cen = np.asarray(centers, dtype=np.float64)
    mean_c = cen.mean(axis=0)
    C = np.column_stack([np.ones(len(cen)), cen - mean_c])
    sol, *_ = np.linalg.lstsq(C, dfs, rcond=None)
    df0 = sol[0] - sol[1] * mean_c[0] - sol[2] * mean_c[1]
    plane = np.array([df0, sol[1], sol[2]])
    return fits, plane


def defocus_at_positions(plane, positions):
    """Evaluate the local-defocus plane at particle positions (N, 2) (y, x)."""
    pos = np.asarray(positions, dtype=np.float64)
    return plane[0] + plane[1] * pos[:, 0] + plane[2] * pos[:, 1]


def _model_polar_thickness(g_axis, theta_axis, df_mean, astig, angast_rad,
                           phase, thickness, pixel_size, voltage_kv, cs_mm,
                           w, ring_mask):
    """CTF^2 averaged over sample depth `thickness` (Å):

        <CTF^2>_t = 1/2 - 1/2 cos(2 chi) sinc(lambda g^2 t)

    (sinc normalized: sin(pi x)/(pi x)) — the CTFFIND5 sample-thickness model
    whose nodes sit where the sinc vanishes. thickness: (B,)."""
    g = g_axis[None, :, None] / pixel_size
    df = df_mean[:, None, None] + astig[:, None, None] * torch.cos(
        2.0 * (theta_axis[None, None, :] - angast_rad[:, None, None])
    )
    x = ctf_model.chi(g, df, voltage_kv, cs_mm, phase[:, None, None])
    lam = ctf_model.wavelength(voltage_kv)
    node = torch.sinc(lam * g * g * thickness[:, None, None])
    c2 = 0.5 - 0.5 * torch.cos(2.0 * (x + _amp_phase(w))) * node
    c2 = _band_center(c2, ring_mask[None, :, None], 1)
    norm = torch.sqrt((c2 * c2).mean(dim=(1, 2), keepdim=True) + 1e-12)
    return c2 / norm


def fit_thickness(power, pixel_size, fit: CtfFit,
                  voltage_kv: float = 300.0, cs_mm: float = 2.7,
                  amplitude_contrast: float = 0.07,
                  min_res: float = 30.0, max_res: float = 5.0,
                  t_max: float = 1000.0, n_steps: int = 51):
    """Sample-thickness estimation given a converged CTF fit (the CTFFIND5
    node-fitting step): sweep thickness, re-score the depth-averaged model,
    parabolic-refine the peak. `power` is a tensor; the sweep runs on its
    device.

    Returns (thickness_A, score_curve (n_steps,) numpy)."""
    n_g, n_theta = 384, 64
    dev = power.device
    P_polar, g_axis, theta_axis = polar_resample(power, n_g, n_theta)
    P_norm = _normalize_spectrum(P_polar, g_axis)
    g_inv_a = g_axis / pixel_size
    ring_mask = ((g_inv_a > 1.0 / min_res) & (g_inv_a < 1.0 / max_res)).to(P_norm.dtype)

    df_mean = 0.5 * (fit.df1 + fit.df2)
    astig = 0.5 * (fit.df1 - fit.df2)
    ang = torch.deg2rad(fit.angast)
    # joint (defocus, thickness) sweep: the thin-sample fit absorbs part of
    # the node structure into a defocus bias, so df must be re-searched
    # together with t (CTFFIND5 does the same joint node fit)
    ts = torch.linspace(0.0, t_max, n_steps, device=dev)
    d_offs = torch.linspace(-800.0, 800.0, 17, device=dev)
    rows = _grid(ts, d_offs)

    def model(p):
        tt, dd = p[:, 0], p[:, 1]
        return _model_polar_thickness(
            g_axis, theta_axis, df_mean + dd, astig.expand_as(dd),
            ang.expand_as(dd), fit.phase_shift.expand_as(dd), tt,
            pixel_size, voltage_kv, cs_mm, amplitude_contrast, ring_mask)

    scores2d = _score_grid(P_norm, g_axis, theta_axis, ring_mask, rows,
                           pixel_size, voltage_kv, cs_mm, amplitude_contrast,
                           model_fn=model).reshape(n_steps, 17)
    scores = scores2d.max(dim=1).values.cpu().numpy()  # best over df per thickness
    i = int(np.argmax(scores))
    step = float(t_max) / (n_steps - 1)
    if 0 < i < n_steps - 1:
        s0, s1, s2 = float(scores[i - 1]), float(scores[i]), float(scores[i + 1])
        denom = s0 + s2 - 2 * s1
        frac = 0.5 * (s0 - s2) / denom if abs(denom) > 1e-9 else 0.0
        t_best = i * step + frac * step
    else:
        t_best = i * step
    return t_best, scores


def diagnostic_image(power, pixel_size, fit: CtfFit, voltage_kv=300.0,
                     cs_mm=2.7, w=0.07, size: int = 512):
    """CTFFIND-style diagnostic: fftshifted power spectrum with the fitted
    CTF^2 model rendered in the upper-left half (the `power.mrc` output the
    reference parses/publishes). Returns (size, size) float32 numpy."""
    from pyp_tpu_torch.core.fft import fourier_crop

    ny, nxf = power.shape
    n = ny
    dev = power.device
    # full-plane spectrum by Friedel mirroring, shifted to center
    full = np.zeros((n, n), dtype=np.float32)
    p = power.cpu().numpy()
    full[:, : nxf] = p[:, ::-1]
    full[1:, nxf - 1:] = p[1:, 1:][::-1, :]
    full[0, nxf - 1:] = p[0, 1:]
    full = np.fft.fftshift(full, axes=0)
    if n != size:
        full = fourier_crop(torch.from_numpy(full).to(dev)[None],
                            (size, size))[0].cpu().numpy()
    # contrast-equalize the data half per radial ring
    c = ctf_model.ctf_2d(
        (size, size), pixel_size * n / size,
        *(torch.as_tensor(float(v), device=dev)
          for v in (fit.df1, fit.df2, fit.angast)),
        voltage_kv, cs_mm, w, float(fit.phase_shift), rfft=False,
    ).cpu().numpy()
    model = np.fft.fftshift(c ** 2)
    lo, hi = np.percentile(full, [2, 98])
    data = np.clip((full - lo) / max(hi - lo, 1e-9), 0, 1)
    yy, xx = np.mgrid[0:size, 0:size]
    upper_left = (yy + xx) < size
    out = np.where(upper_left, model, data)
    return out.astype(np.float32)
