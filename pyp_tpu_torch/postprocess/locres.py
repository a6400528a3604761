"""Local resolution estimation and local filtering — the torch port of
pyp_tpu/postprocess/locres.py (the relion_postprocess --locres contract).

Sample points lie on a regular grid (`sampling_a` Å apart); one window per
point is cut from both half maps (ops.extract.subvolume_gather) under one
soft spherical mask, and every window's FSC is computed in one batched
rfftn with the shell sums as one-hot matmuls. The mask correction uses
half maps phase-randomized once beyond `randomize_at_a`, through the same
batched FSC and the part-FSC formula. Each point's resolution is the
threshold crossing clamped to [2 pixel, minres_a], trilinearly
interpolated back onto the full grid. The local filter hat-blends a
log-spaced bank of cosine lowpasses by each voxel's local resolution."""

from __future__ import annotations

import numpy as np
import torch

from pyp_tpu_torch import as_f32, resolve_device
from pyp_tpu_torch.core import fsc as fsc_mod
from pyp_tpu_torch.core.filters import lowpass_filter_3d, soft_spherical_mask
from pyp_tpu_torch.ops.extract import subvolume_gather
from pyp_tpu_torch.postprocess import core as post_core


def _batched_window_fsc(w1, w2, n_bins: int):
    """FSC curves for paired window batches (W, w, w, w) -> (W, n_bins):
    one rfftn over the batch, the shell sums as one-hot matmuls."""
    w = w1.shape[-1]
    F1 = torch.fft.rfftn(w1, dim=(1, 2, 3)).reshape(w1.shape[0], -1)
    F2 = torch.fft.rfftn(w2, dim=(1, 2, 3)).reshape(w2.shape[0], -1)
    onehot = torch.nn.functional.one_hot(
        fsc_mod._shell_bins(w, n_bins, w1.device), n_bins).to(torch.float32)
    num = (F1 * F2.conj()).real @ onehot
    d1 = (F1.real ** 2 + F1.imag ** 2) @ onehot
    d2 = (F2.real ** 2 + F2.imag ** 2) @ onehot
    return num / torch.clamp(torch.sqrt(d1 * d2), min=1e-12)


def _resolutions_at_threshold(curves, pixel_size: float, threshold: float):
    """First-crossing resolution of each curve (W, S) -> (W,) in Å; a curve
    that never crosses reads Nyquist."""
    n_bins = curves.shape[-1]
    freqs = ((torch.arange(n_bins, dtype=torch.float32, device=curves.device)
              + 0.5) * (0.5 / n_bins))
    below = curves < threshold
    below[:, 0] = False
    idx = torch.argmax(below.to(torch.int32), dim=1)
    crossed = below.any(dim=1)
    i0 = torch.clamp(idx - 1, min=0)
    c0 = torch.gather(curves, 1, i0[:, None])[:, 0]
    c1 = torch.gather(curves, 1, idx[:, None])[:, 0]
    t = torch.clamp((c0 - threshold) / torch.clamp(c0 - c1, min=1e-9),
                    0.0, 1.0)
    f = freqs[i0] + t * (freqs[idx] - freqs[i0])
    f = torch.where(crossed, f, torch.full_like(f, 0.5))
    return pixel_size / torch.clamp(f, min=1e-6)


def _interp(x, xp, fp):
    """np.interp for tensors: piecewise-linear through (xp, fp) (xp
    increasing), clamped to fp[0] / fp[-1] outside [xp[0], xp[-1]]."""
    xc = torch.clamp(x, xp[0], xp[-1])
    i = torch.clamp(torch.searchsorted(xp, xc, right=True) - 1, 0,
                    len(xp) - 2)
    t = (xc - xp[i]) / torch.clamp(xp[i + 1] - xp[i], min=1e-30)
    return fp[i] + t * (fp[i + 1] - fp[i])


def _trilinear_nearest(coarse, zz, yy, xx):
    """Trilinear samples of a (Z, Y, X) grid at fractional indices, edges
    clamped (map_coordinates order=1, mode="nearest"), as explicit corner
    weights."""
    dims = coarse.shape
    out = torch.zeros_like(zz)
    lo, fr = [], []
    for c, d in zip((zz, yy, xx), dims):
        c = torch.clamp(c, 0.0, float(d - 1))
        f0 = torch.floor(c)
        lo.append(f0.to(torch.int64))
        fr.append(c - f0)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                w = ((fr[0] if dz else 1 - fr[0]) * (fr[1] if dy else 1 - fr[1])
                     * (fr[2] if dx else 1 - fr[2]))
                iz = torch.clamp(lo[0] + dz, max=dims[0] - 1)
                iy = torch.clamp(lo[1] + dy, max=dims[1] - 1)
                ix = torch.clamp(lo[2] + dx, max=dims[2] - 1)
                out = out + w * coarse[iz, iy, ix]
    return out


def local_resolution(half1, half2, pixel_size: float, sampling_a: float = 25.0,
                     maskrad_a: float = -1.0, edgwidth_a: float = -1.0,
                     randomize_at_a: float = 25.0, minres_a: float = 50.0,
                     threshold: float = 0.143, batch: int = 64,
                     device="cuda"):
    """Local resolution map of two half maps (numpy or tensors), computed
    on `device`. Returns (locres_map (n³) tensor in Å, points (G, 3) numpy
    voxel coordinates, values (G,) numpy Å). Defaults follow
    relion_postprocess: mask radius half the sampling, edge width the
    sampling."""
    dev = resolve_device(device)
    half1 = as_f32(half1, dev)
    half2 = as_f32(half2, dev)
    n = half1.shape[-1]
    if maskrad_a <= 0:
        maskrad_a = 0.5 * sampling_a
    if edgwidth_a <= 0:
        edgwidth_a = sampling_a
    # window big enough for mask + soft edge; even for clean rfft shells
    w = int(np.ceil(2.0 * (maskrad_a + edgwidth_a) / pixel_size))
    w = min(max(w + (w % 2), 16), n)
    n_bins = w // 2
    mask = soft_spherical_mask(w, maskrad_a / pixel_size,
                               edgwidth_a / pixel_size, device=dev)
    step = max(1, int(round(sampling_a / pixel_size)))
    ax = np.arange(w // 2, n - w // 2 + step, step)
    ax = np.clip(ax, w // 2, max(n - w // 2, w // 2))[: max(1, len(ax))]
    ax = np.unique(ax)
    gz, gy, gx = np.meshgrid(ax, ax, ax, indexing="ij")
    points = np.stack([gz, gy, gx], -1).reshape(-1, 3).astype(np.int32)

    cutoff_bin_w = int(round(2.0 * n_bins * pixel_size / randomize_at_a))
    cutoff_bin_w = min(max(cutoff_bin_w, 2), n_bins - 2)
    r1 = _randomize_beyond(half1, pixel_size, randomize_at_a, seed=1)
    r2 = _randomize_beyond(half2, pixel_size, randomize_at_a, seed=2)
    shell = torch.arange(n_bins, device=dev)[None, :]
    values = []
    for lo in range(0, len(points), batch):
        pts = torch.as_tensor(points[lo:lo + batch], device=dev)
        curves = _batched_window_fsc(subvolume_gather(half1, pts, w) * mask,
                                     subvolume_gather(half2, pts, w) * mask,
                                     n_bins)
        rand = _batched_window_fsc(subvolume_gather(r1, pts, w) * mask,
                                   subvolume_gather(r2, pts, w) * mask,
                                   n_bins)
        # part-FSC correction beyond the randomization shell (+2 guard)
        corr = (curves - rand) / torch.clamp(1.0 - rand, min=1e-6)
        curves = torch.where(shell >= cutoff_bin_w + 2, corr, curves)
        values.append(_resolutions_at_threshold(curves, pixel_size,
                                                threshold).cpu().numpy())
    values = np.clip(np.concatenate(values), 2.0 * pixel_size, minres_a)

    coarse = as_f32(values.reshape(len(ax), len(ax), len(ax)), dev)
    idx = _interp(torch.arange(n, dtype=torch.float32, device=dev),
                  as_f32(ax, dev),
                  torch.arange(len(ax), dtype=torch.float32, device=dev))
    zz, yy, xx = torch.meshgrid(idx, idx, idx, indexing="ij")
    return _trilinear_nearest(coarse, zz, yy, xx), points, values


def _randomize_beyond(vol, pixel_size: float, res_a: float, seed: int = 0):
    """Phase-randomize a volume tensor beyond a resolution shell (phases
    from postprocess.core._random_phases)."""
    n = vol.shape[-1]
    n_bins = n // 2
    F = torch.fft.rfftn(vol)
    bins = fsc_mod._shell_bins(n, n_bins, vol.device).reshape(F.shape)
    cutoff = int(round(2.0 * n_bins * pixel_size / res_a))
    cutoff = min(max(cutoff, 2), n_bins - 2)
    return torch.fft.irfftn(post_core._phase_randomize(F, bins, cutoff, seed),
                            s=vol.shape)


def local_filter(vol, locres_map, pixel_size: float, n_bank: int = 10):
    """Per-voxel cosine lowpass of a map tensor at the local resolution:
    a log-spaced bank of lowpasses between the sharpest and softest local
    values, each voxel hat-blended between its two adjacent members."""
    vol = vol.to(torch.float32)
    lr = locres_map.to(torch.float32)
    lo, hi = float(lr.min()), float(lr.max())
    if hi - lo < 1e-3:
        return lowpass_filter_3d(vol, pixel_size, 0.5 * (lo + hi))
    bank = np.geomspace(lo, hi, n_bank).astype(np.float32)
    pos = _interp(lr, as_f32(bank, vol.device),
                  torch.arange(n_bank, dtype=torch.float32, device=vol.device))
    out = torch.zeros_like(vol)
    for k, res in enumerate(bank):
        wk = torch.clamp(1.0 - torch.abs(pos - k), 0.0, 1.0)
        out = out + wk * lowpass_filter_3d(vol, pixel_size, float(res))
    return out
