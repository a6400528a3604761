"""Movie-frame motion correction (beam-induced motion) — the torch port of
pyp_tpu/ops/motion.py.

The algorithm follows the published unblur scheme, batched:

  1. all frames are FFT'd once; per iteration, each frame is cross-correlated
     against the B-factor-weighted running sum of all *other* frames at their
     current shifts (leave-one-out reference), all frames in one batched op;
  2. the correlation surface is evaluated with a zoom DFT on a window just
     covering the search radius (two complex matmuls) and its peak refined
     to sub-pixel precision by quadratic interpolation; shifts are capped to
     the search radius;
  3. trajectories are regularized by a least-squares polynomial in time;
  4. outputs: per-frame shifts (pixels), aligned average, and an optionally
     dose-weighted average (Grant-Grigorieff, matching summovie).

The whole movie stays on the device it was given on. Camera-sized movies go
through `align_movie_large`: one rfft2 per frame (in chunks sized from the
free device memory) gives the stored full spectra and their Fourier-binned
crop; alignment iterates on the binned spectra, and the average accumulates
from the stored full spectra.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pyp_tpu_torch import resolve_device
from pyp_tpu_torch.core.ctf import dose_weight, dose_weight_2d
from pyp_tpu_torch.core.fft import freq_grid_2d, phase_ramp, shift_images


class MotionResult(NamedTuple):
    shifts: torch.Tensor      # (n_frames, 2) in pixels (y, x)
    average: torch.Tensor     # (ny, nx) aligned sum
    converged: torch.Tensor   # 0-dim: last max shift update (px)


def _frames_on(frames, device) -> torch.Tensor:
    """float32 frames on `device`; a tensor already there is not copied."""
    dev = resolve_device(device)
    if not isinstance(frames, torch.Tensor):
        frames = torch.from_numpy(np.ascontiguousarray(frames))
    return frames.to(device=dev, dtype=torch.float32)


def _weight_filter(ny, nx, pixel_size, bfactor, low_res, high_res,
                   device=None):
    """B-factor + band-limit weighting applied to spectra before xcorr."""
    fy, fx = freq_grid_2d(ny, nx, device=device)
    g2 = (fy * fy + fx * fx) / (pixel_size * pixel_size)
    w = torch.exp(-0.25 * bfactor * g2)
    g = torch.sqrt(g2)
    if low_res > 0:
        w = w * (g > 1.0 / low_res)
    if high_res > 0:
        w = w * (g < 1.0 / high_res)
    # kill DC so constant offsets don't dominate
    w[0, 0] = 0.0
    return w


def _phase_ramp(shifts, ny, nx):
    return phase_ramp(shifts, ny, nx)


def _parabola_offsets(c0, cym, cyp, cxm, cxp):
    """Sub-pixel offsets of a peak from its four neighbours: a 1D parabola
    in each axis, offset = (c- - c+) / (2 (c- + c+ - 2 c0)), clipped to
    half a pixel."""
    denom_y = cym + cyp - 2.0 * c0
    denom_x = cxm + cxp - 2.0 * c0
    zero = torch.zeros_like(c0)
    off_y = torch.where(denom_y.abs() > 1e-12, 0.5 * (cym - cyp) / denom_y, zero)
    off_x = torch.where(denom_x.abs() > 1e-12, 0.5 * (cxm - cxp) / denom_x, zero)
    return torch.clamp(off_y, -0.5, 0.5), torch.clamp(off_x, -0.5, 0.5)


def _subpixel_peak(cc):
    """Argmax of a (batched) correlation surface with quadratic refinement.

    cc: (..., ny, nx) real. Returns (..., 2) peak positions as signed shifts
    in pixels (FFT-centered: peak at index p > n/2 means p - n).
    """
    ny, nx = cc.shape[-2], cc.shape[-1]
    flat = cc.reshape(cc.shape[:-2] + (-1,))
    flat_idx = torch.argmax(flat, dim=-1)
    py = flat_idx // nx
    px = flat_idx % nx

    def gather(dy, dx):
        idx = ((py + dy) % ny) * nx + ((px + dx) % nx)
        return torch.gather(flat, -1, idx[..., None])[..., 0]

    off_y, off_x = _parabola_offsets(gather(0, 0), gather(-1, 0), gather(1, 0),
                                     gather(0, -1), gather(0, 1))
    sy = torch.where(py > ny // 2, py - ny, py) + off_y
    sx = torch.where(px > nx // 2, px - nx, px) + off_x
    return torch.stack([sy, sx], dim=-1)


def _zoom_matrices(ny, nx, window: int, device=None):
    """DFT matrices evaluating the cross-correlation on a [-W/2, W/2)^2
    pixel window only (zoom DFT): the full irfft2 computes ny*nx correlation
    values per frame when the peak is known to lie within the search
    radius; the windowed evaluation is two complex matmuls.

    Returns Ay (W, ny) and Bx (nxf, W) complex64; Bx carries the rfft
    double-count weights so Re(Ay @ S @ Bx) equals the irfft2 exactly."""
    W = int(window)
    d = np.arange(W) - W // 2
    fy = np.fft.fftfreq(ny)
    fx = np.fft.rfftfreq(nx)
    Ay = np.exp(2j * np.pi * np.outer(d, fy)).astype(np.complex64)
    wts = np.full(len(fx), 2.0, dtype=np.float32)
    wts[0] = 1.0
    if nx % 2 == 0:
        wts[-1] = 1.0
    Bx = (wts[:, None] * np.exp(2j * np.pi * np.outer(fx, d))).astype(
        np.complex64)
    return (torch.from_numpy(Ay).to(device), torch.from_numpy(Bx).to(device))


def _zoom_cc(S, Ay, Bx):
    """cc[f, dy, dx] = Re(Ay @ S[f] @ Bx) — batched windowed correlation.
    Ay is contracted first: it shrinks the ny axis to the window."""
    return torch.matmul(torch.matmul(Ay, S), Bx).real


def _subpixel_peak_win(cc, window: int):
    """Peak of a (B, W, W) windowed correlation with quadratic refinement.
    Window index W//2 is shift 0; no wraparound (the window is open)."""
    B, W, _ = cc.shape
    flat = cc.reshape(B, -1)
    flat_idx = torch.argmax(flat, dim=-1)
    py = torch.clamp(flat_idx // W, 1, W - 2)
    px = torch.clamp(flat_idx % W, 1, W - 2)

    def gather(dy, dx):
        return torch.gather(flat, -1, ((py + dy) * W + (px + dx))[:, None])[:, 0]

    off_y, off_x = _parabola_offsets(gather(0, 0), gather(-1, 0), gather(1, 0),
                                     gather(0, -1), gather(0, 1))
    sy = py.to(torch.float32) - W // 2 + off_y
    sx = px.to(torch.float32) - W // 2 + off_x
    return torch.stack([sy, sx], dim=-1)


def _polyfit_projector(n: int, order: int, device=None):
    """The (n, n) matrix A pinv(A) of the least-squares polynomial of
    `order` over n points of [-1, 1]: it depends on (n, order) only, so it
    is built once in float64 on the host and applied as one matmul."""
    t = np.linspace(-1.0, 1.0, n)
    A = np.stack([t ** k for k in range(order + 1)], axis=1)
    return torch.from_numpy((A @ np.linalg.pinv(A)).astype(np.float32)).to(device)


def _polyfit_smooth(shifts, order):
    """Least-squares polynomial smoothing of a (n_frames, 2) trajectory."""
    return _polyfit_projector(shifts.shape[0], order, shifts.device) @ shifts


def align_movie(
    frames,
    pixel_size: float = 1.0,
    bfactor: float = 1500.0,
    low_res: float = 0.0,
    high_res: float = 0.0,
    max_iters: int = 8,
    search_radius: float = 48.0,
    smooth_order: int = 3,
    center: bool = True,
    ref: str = "average",
    phase_only: bool = False,
    tol: float = 0.0,
    device="cuda",
) -> MotionResult:
    """Align movie frames to their common average (global motion).

    frames: (n_frames, ny, nx) float. Returns shifts such that
    shift_images(frames[i], shifts[i]) aligns frame i to the average.

    phase_only: correlate unit-magnitude cross spectra (MotionCor's
    phase-only switch) — robust to fixed-pattern amplitude structure.
    tol: convergence tolerance in px (MotionCor tol card): once the max
    per-frame shift update drops below it, later iterations stop moving
    (the trip count stays max_iters; the answer matches early
    termination)."""
    frames = _frames_on(frames, device)
    n_frames, ny, nx = frames.shape
    w = _weight_filter(ny, nx, pixel_size, bfactor, low_res, high_res,
                       frames.device)
    F = torch.fft.rfft2(frames)
    shifts, last_delta = _align_spectra(
        F * w, ny, nx, max_iters=max_iters, search_radius=search_radius,
        smooth_order=smooth_order, ref=ref, phase_only=phase_only, tol=tol)
    if center:
        shifts = shifts - shifts.mean(dim=0, keepdim=True)
    ramps = _phase_ramp(shifts, ny, nx)
    average = torch.fft.irfft2((F * ramps).sum(dim=0), s=(ny, nx)) / n_frames
    return MotionResult(shifts=shifts, average=average, converged=last_delta)


def _zoom_window(search_radius: float, ny: int, nx: int) -> int:
    """The zoom window: the clamped absolute shift plus an interpolation
    margin, padded to a multiple of 64, at most the image."""
    window = max(64, int(2 * (int(search_radius) + 4 + 31) // 64) * 64)
    return min(window, min(ny, nx))


def _align_spectra(Fw, ny, nx, max_iters: int = 8,
                   search_radius: float = 48.0, smooth_order: int = 3,
                   ref: str = "average", phase_only: bool = False,
                   tol: float = 0.0, zoom: bool = True):
    """Iterative leave-one-out alignment on weighted spectra Fw
    (n_frames, ny, nx//2+1). The per-iteration correlation surface is
    evaluated with a zoom DFT on a window just covering the search radius;
    `zoom=False` takes a full irfft2 and cuts the same window out of it
    (the same values, for timing one against the other). No iteration
    reads a value on the host. Returns (shifts, delta)."""
    n_frames = Fw.shape[0]
    dev = Fw.device
    window = _zoom_window(search_radius, ny, nx)
    if zoom:
        Ay, Bx = _zoom_matrices(ny, nx, window, dev)
    else:
        d = torch.arange(window, device=dev) - window // 2
        wy, wx = (d % ny)[:, None], (d % nx)[None, :]
    smooth = smooth_order > 0 and n_frames > smooth_order + 1
    if smooth:
        proj = _polyfit_projector(n_frames, smooth_order, dev)
    mid = n_frames // 2
    shifts = torch.zeros((n_frames, 2), dtype=torch.float32, device=dev)
    delta = torch.tensor(1e9, dtype=torch.float32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    conj_Fw = torch.conj(Fw)
    for _ in range(max_iters):
        aligned = Fw * _phase_ramp(shifts, ny, nx)
        if ref == "middle":
            # middle-frame reference (MotionCor-style seed): robust when
            # early frames carry most of the dose-rate distortion
            reference = aligned[mid:mid + 1]
        else:
            # leave-one-out per frame
            reference = aligned.sum(dim=0, keepdim=True) - aligned
        # xcorr of reference against *unshifted* frame gives absolute shift
        S = reference * conj_Fw
        if phase_only:
            S = S / torch.clamp(S.abs(), min=1e-12)
        if zoom:
            cc = _zoom_cc(S, Ay, Bx)
        else:
            cc = torch.fft.irfft2(S, s=(ny, nx))[:, wy, wx]
        new_shifts = _subpixel_peak_win(cc, window)
        r = torch.sqrt((new_shifts ** 2).sum(dim=-1, keepdim=True))
        scale = torch.where(r > search_radius,
                            search_radius / torch.clamp(r, min=1e-6),
                            torch.ones_like(r))
        new_shifts = new_shifts * scale
        if smooth:
            new_shifts = proj @ new_shifts
        delta = (new_shifts - shifts).abs().max()
        shifts = torch.where(done, shifts, new_shifts)
        if tol > 0:
            done = done | (delta < tol)
    return shifts, delta


def dose_weighted_average(frames, shifts, doses, pixel_size: float = 1.0):
    """Shift frames and sum with Grant-Grigorieff per-frequency dose weights.

    doses: (n_frames,) cumulative exposure at the *end* of each frame (e-/Å²).
    """
    n_frames, ny, nx = frames.shape
    F = torch.fft.rfft2(frames) * _phase_ramp(shifts, ny, nx)
    w = dose_weight_2d((ny, nx), pixel_size, doses, device=frames.device)
    return torch.fft.irfft2((F * w).sum(dim=0), s=(ny, nx)) / n_frames


def extract_patches(frames, patch_grid):
    """Split frames into a (gy, gx) grid of patches: returns
    (gy*gx, n_frames, py, px) with py/px floor-divided."""
    n_frames, ny, nx = frames.shape
    gy, gx = patch_grid
    py, px = ny // gy, nx // gx
    t = frames[:, : gy * py, : gx * px].reshape(n_frames, gy, py, gx, px)
    return t.permute(1, 3, 0, 2, 4).reshape(gy * gx, n_frames, py, px)


def align_movie_patches(
    frames,
    patch_grid=(5, 5),
    pixel_size: float = 1.0,
    bfactor: float = 500.0,
    max_iters: int = 6,
    smooth_order: int = 3,
    device="cuda",
    **kw,
):
    """MotionCor-style local (patch) motion: global pass, then per-patch
    alignment refined on globally-aligned frames. Returns
    (global_result, patch_shifts (gy*gx, n_frames, 2), patch_centers (gy*gx, 2)).

    The caller can fit a smooth (x, y, t) polynomial over patch shifts for
    warping; per-particle trajectories interpolate these.
    """
    frames = _frames_on(frames, device)
    n_frames, ny, nx = frames.shape
    glob = align_movie(
        frames, pixel_size=pixel_size, bfactor=bfactor, max_iters=max_iters,
        smooth_order=smooth_order, device=frames.device, **kw,
    )
    patches = extract_patches(shift_images(frames, glob.shifts), patch_grid)
    results = torch.stack([
        align_movie(p, pixel_size=pixel_size, bfactor=bfactor,
                    max_iters=max_iters, search_radius=8.0,
                    smooth_order=smooth_order, device=frames.device).shifts
        for p in patches])
    gy, gx = patch_grid
    py, px = ny // gy, nx // gx
    cy = torch.arange(gy, device=frames.device) * py + py / 2.0
    cx = torch.arange(gx, device=frames.device) * px + px / 2.0
    centers = torch.stack(torch.meshgrid(cy, cx, indexing="ij"),
                          dim=-1).reshape(-1, 2)
    return glob, results, centers


def interpolate_local_shifts(patch_shifts, patch_centers, positions, shape,
                             order=2):
    """Fit a 2D polynomial (per frame) to patch shifts and evaluate at given
    positions: the per-particle trajectory model used for polishing.

    patch_shifts: (P, n_frames, 2); positions: (N, 2) in pixels.
    Returns (N, n_frames, 2) on the patch shifts' device. The fit is a
    small dense least-squares problem, solved in float64.
    """
    ny, nx = shape
    dev = patch_shifts.device
    centers = torch.as_tensor(patch_centers, device=dev).to(torch.float64)
    positions = torch.as_tensor(positions, device=dev).to(torch.float64)

    def basis(y, x):
        terms = [torch.ones_like(y)]
        for total in range(1, order + 1):
            for i in range(total + 1):
                terms.append((y ** (total - i)) * (x ** i))
        return torch.stack(terms, dim=-1)

    A = basis((centers[:, 0] / ny) * 2 - 1, (centers[:, 1] / nx) * 2 - 1)
    # solve per frame, both components at once: (P, n_frames*2)
    P, n_frames, _ = patch_shifts.shape
    B = patch_shifts.reshape(P, n_frames * 2).to(torch.float64)
    coef = torch.linalg.pinv(A) @ B
    Aq = basis((positions[:, 0] / ny) * 2 - 1, (positions[:, 1] / nx) * 2 - 1)
    return (Aq @ coef).to(torch.float32).reshape(-1, n_frames, 2)


def running_average(frames, window: int = 3):
    """Centered running average over the frame axis (the reference's
    compute_running_avg, used by CSP mode -2.1); the ends repeat the first
    and last frame."""
    n = frames.shape[0]
    pad = window // 2
    idx = torch.clamp(torch.arange(n + 2 * pad, device=frames.device) - pad,
                      0, n - 1)
    fp = frames[idx]
    out = torch.zeros_like(frames, dtype=torch.float32)
    for k in range(window):
        out += fp[k:k + n]
    return out / window


def weighted_average(frames, weights):
    """Per-frame weighted 2D average (the reference's weight_average):
    weights (n_frames,) or (n_frames, ny, nxf) Fourier weights."""
    weights = torch.as_tensor(weights, dtype=torch.float32,
                              device=frames.device)
    if weights.ndim == 1:
        return torch.einsum("f,fyx->yx", weights / weights.sum(), frames)
    out = (torch.fft.rfft2(frames) * weights).sum(dim=0) / frames.shape[0]
    return torch.fft.irfft2(out, s=frames.shape[-2:])


def _fft_chunk(n_frames: int, ny: int, nx: int, device) -> int:
    """Frames per batched rfft2: all of them on the CPU; on a card, as many
    as fit a quarter of the free memory (input, spectrum and the FFT's
    workspace per frame)."""
    if torch.device(device).type != "cuda":
        return n_frames
    free, _ = torch.cuda.mem_get_info(device)
    per_frame = 4 * ny * nx * 4
    return int(max(1, min(n_frames, (free // 4) // per_frame)))


def _bin_frames(frames, binning: int):
    """Fourier-bin frames in chunks."""
    from pyp_tpu_torch.core.fft import fourier_crop

    n_frames, ny, nx = frames.shape
    step = _fft_chunk(n_frames, ny, nx, frames.device)
    return torch.cat([
        fourier_crop(frames[lo:lo + step], (ny // binning, nx // binning))
        for lo in range(0, n_frames, step)])


def _spectra(frames, binning: int):
    """One rfft2 per frame, returning BOTH the full spectrum stack and its
    Fourier-cropped (binned) version scaled by 1/binning². Alignment runs
    on the binned spectra and the final average reuses the stored full
    spectra — the movie is FFT'd exactly once."""
    n_frames, ny, nx = frames.shape
    nys, nxs = ny // binning, nx // binning
    half = nys // 2
    nxf_s = nxs // 2 + 1
    dev = frames.device
    F_full = torch.empty((n_frames, ny, nx // 2 + 1), dtype=torch.complex64,
                         device=dev)
    F_small = torch.empty((n_frames, 2 * half, nxf_s), dtype=torch.complex64,
                          device=dev)
    step = _fft_chunk(n_frames, ny, nx, dev)
    for lo in range(0, n_frames, step):
        F = torch.fft.rfft2(frames[lo:lo + step])
        F_full[lo:lo + step] = F
        F_small[lo:lo + step, :half] = F[:, :half, :nxf_s]
        F_small[lo:lo + step, half:] = F[:, ny - half:, :nxf_s]
    F_small /= binning * binning
    return F_full, F_small


def _align_small(F_small, nys: int, nxs: int, pixel_size: float,
                 bfactor: float, low_res: float, high_res: float,
                 max_iters: int, search_radius: float, smooth_order: int,
                 center: bool, ref: str):
    w = _weight_filter(nys, nxs, pixel_size, bfactor, low_res, high_res,
                       F_small.device)
    shifts, delta = _align_spectra(
        F_small * w, nys, nxs, max_iters=max_iters,
        search_radius=search_radius, smooth_order=smooth_order, ref=ref)
    if center:
        shifts = shifts - shifts.mean(dim=0, keepdim=True)
    return shifts, delta


def _dose_norm(g, doses):
    """sqrt(sum_f w_f²) of the dose weights over frames, floored."""
    wsq = torch.zeros_like(g)
    for dose_e in doses:
        wsq += dose_weight(g, dose_e) ** 2
    return torch.sqrt(torch.clamp(wsq, min=1e-12))


def _average_spectra_scan(F_full, shifts, doses, ny: int, nx: int,
                          pixel_size: float = 1.0,
                          dose_weighted: bool = True):
    """The aligned (dose-weighted) average from precomputed spectra,
    weighted in chunks of frames and summed frame by frame, so the chunk
    (which follows the card's free memory) changes no bit of the result.
    The dose weights are normalized by sqrt(sum_f w_f²) floored at 1e-6
    (`dose_weighted_average` floors its norm at 1e-8 through
    dose_weight_2d)."""
    n_frames = F_full.shape[0]
    dev = F_full.device
    fy, fx = freq_grid_2d(ny, nx, device=dev)
    g = torch.sqrt((fy / pixel_size) ** 2 + (fx / pixel_size) ** 2)
    doses = torch.as_tensor(doses, dtype=torch.float32, device=dev)
    if dose_weighted:
        wnorm = _dose_norm(g, doses)
    acc = torch.zeros((ny, nx // 2 + 1), dtype=torch.complex64, device=dev)
    step = max(1, _fft_chunk(n_frames, ny, nx, dev) // 2)
    for lo in range(0, n_frames, step):
        F = F_full[lo:lo + step] * _phase_ramp(shifts[lo:lo + step], ny, nx)
        if dose_weighted:
            F = F * (dose_weight(g[None], doses[lo:lo + step, None, None])
                     / wnorm)
        for frame in F:
            acc += frame
    return torch.fft.irfft2(acc, s=(ny, nx)) / n_frames


def _average_scan(frames, shifts, doses, pixel_size: float = 1.0,
                  dose_weighted: bool = True):
    """Aligned (dose-weighted) average of real-space frames, transformed
    in chunks (peak memory is one chunk's spectra instead of the whole
    stack's) and summed in Fourier space frame by frame, so the chunk
    (which follows the card's free memory) changes no bit of the result."""
    n_frames, ny, nx = frames.shape
    dev = frames.device
    doses = torch.as_tensor(doses, dtype=torch.float32, device=dev)
    acc = torch.zeros((ny, nx // 2 + 1), dtype=torch.complex64, device=dev)
    step = _fft_chunk(n_frames, ny, nx, dev)
    fy, fx = freq_grid_2d(ny, nx, device=dev)
    g = torch.sqrt((fy / pixel_size) ** 2 + (fx / pixel_size) ** 2)
    wnorm = _dose_norm(g, doses) if dose_weighted else None
    for lo in range(0, n_frames, step):
        F = torch.fft.rfft2(frames[lo:lo + step]) * _phase_ramp(
            shifts[lo:lo + step], ny, nx)
        if dose_weighted:
            F = F * (dose_weight(g[None], doses[lo:lo + step, None, None])
                     / wnorm)
        for frame in F:
            acc += frame
    return torch.fft.irfft2(acc, s=(ny, nx)) / n_frames


def align_movie_large(
    frames,
    pixel_size: float = 1.0,
    binning: int = 2,
    doses=None,
    dose_weighted: bool = True,
    device="cuda",
    **kw,
) -> MotionResult:
    """Movie alignment for camera-sized movies (K3: 40 x 4096²): one rfft2
    per frame produces both the stored full spectrum and its Fourier-binned
    crop; alignment iterates on the binned spectra with zoom-DFT
    correlations (no per-iteration FFTs), and the dose-weighted average
    accumulates from the stored full spectra (no second FFT pass). Drift is
    resolution-independent; shifts scale by the bin factor."""
    frames = _frames_on(frames, device)
    n_frames, ny, nx = frames.shape
    if doses is None:
        doses = torch.arange(1, n_frames + 1, dtype=torch.float32,
                             device=frames.device)
    if binning <= 1:
        res = align_movie(frames, pixel_size=pixel_size,
                          device=frames.device, **kw)
        avg = _average_scan(frames, res.shifts, doses, pixel_size,
                            dose_weighted)
        return MotionResult(shifts=res.shifts, average=avg,
                            converged=res.converged)
    F_full, F_small = _spectra(frames, binning)
    nys, nxs = ny // binning, nx // binning
    shifts_small, delta = _align_small(
        F_small, nys, nxs, pixel_size * binning,
        bfactor=float(kw.get("bfactor", 1500.0)),
        low_res=float(kw.get("low_res", 0.0)),
        high_res=float(kw.get("high_res", 0.0)),
        max_iters=int(kw.get("max_iters", 8)),
        search_radius=float(kw.get("search_radius", 48.0 / binning)),
        smooth_order=int(kw.get("smooth_order", 3)),
        center=bool(kw.get("center", True)),
        ref=str(kw.get("ref", "average")))
    del F_small
    shifts = shifts_small * binning
    avg = _average_spectra_scan(F_full, shifts, doses, ny, nx, pixel_size,
                                dose_weighted)
    return MotionResult(shifts=shifts, average=avg, converged=delta)


def bilinear_sample(imgs, sy, sx):
    """Bilinear samples of (..., ny, nx) images at float coordinates (sy,
    sx) of one common shape, coordinates clamped to the image (what
    map_coordinates(order=1, mode="nearest") computes)."""
    ny, nx = imgs.shape[-2:]
    sy = torch.clamp(sy, 0.0, ny - 1.0)
    sx = torch.clamp(sx, 0.0, nx - 1.0)
    y0 = torch.clamp(torch.floor(sy).to(torch.int64), 0, ny - 1)
    x0 = torch.clamp(torch.floor(sx).to(torch.int64), 0, nx - 1)
    y1 = torch.clamp(y0 + 1, max=ny - 1)
    x1 = torch.clamp(x0 + 1, max=nx - 1)
    wy = sy - y0
    wx = sx - x0
    return (imgs[..., y0, x0] * (1 - wy) * (1 - wx)
            + imgs[..., y1, x0] * wy * (1 - wx)
            + imgs[..., y0, x1] * (1 - wy) * wx
            + imgs[..., y1, x1] * wy * wx)


def correct_mag_distortion(frames, mag_major: float, mag_minor: float,
                           angle_deg: float):
    """Anisotropic-magnification correction (MotionCor -Mag role; reference
    movie tab magcorr + scope mag_major/mag_minor/distort_ang): resample
    every frame through the inverse of the distortion affine
    R(-a) diag(major, minor) R(a), bilinear, about the image center.

    frames: (..., ny, nx) tensor. The distortion scales the image along the
    major axis (rotated `angle_deg` from x); correction divides it back
    out."""
    ny, nx = frames.shape[-2:]
    dev = frames.device
    a = np.deg2rad(np.float32(angle_deg))
    c, s = np.cos(a), np.sin(a)
    R = np.array([[c, -s], [s, c]], np.float32)               # (x, y) order
    A = R @ np.diag(np.array([mag_major, mag_minor], np.float32)) @ R.T
    yy = torch.arange(ny, dtype=torch.float32, device=dev) - (ny - 1) / 2.0
    xx = torch.arange(nx, dtype=torch.float32, device=dev) - (nx - 1) / 2.0
    gy, gx = torch.meshgrid(yy, xx, indexing="ij")
    # corrected pixel (gx, gy) samples the distorted image at A @ (gx, gy)
    sx = float(A[0, 0]) * gx + float(A[0, 1]) * gy + (nx - 1) / 2.0
    sy = float(A[1, 0]) * gx + float(A[1, 1]) * gy + (ny - 1) / 2.0
    flat = frames.reshape((-1, ny, nx)).to(torch.float32)
    out = torch.empty_like(flat)
    step = _fft_chunk(flat.shape[0], ny, nx, dev)
    for lo in range(0, flat.shape[0], step):
        out[lo:lo + step] = bilinear_sample(flat[lo:lo + step], sy, sx)
    return out.reshape(frames.shape)
