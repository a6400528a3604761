"""Fourier shell correlation and derived statistics — the torch port of
pyp_tpu/core/fsc.py: shell-wise correlation of two half maps, the
resolution at a threshold, the part-FSC mask correction, SSNR, the Cref
filter and the amplitude-correlation / phase-residual curves."""

from __future__ import annotations

import numpy as np
import torch


def _shell_bins(n: int, n_bins: int, device):
    fz = np.fft.fftfreq(n).reshape(n, 1, 1)
    fy = np.fft.fftfreq(n).reshape(1, n, 1)
    fx = np.fft.rfftfreq(n).reshape(1, 1, -1)
    r = np.sqrt(fz**2 + fy**2 + fx**2)
    bins = np.clip((r / 0.5 * n_bins).astype(np.int32), 0, n_bins - 1)
    return torch.as_tensor(bins.reshape(-1).astype(np.int64), device=device)


def _shell_sum(values, bins, n_bins):
    out = torch.zeros(n_bins, dtype=values.dtype, device=values.device)
    return out.index_add_(0, bins, values)


def fsc(map1, map2, n_bins: int | None = None):
    """FSC curve between two cubic volumes. Returns (freqs, fsc) where freqs
    are shell centers in cycles/pixel."""
    n = map1.shape[-1]
    if n_bins is None:
        n_bins = n // 2
    f1 = torch.fft.rfftn(map1.to(torch.float32)).reshape(-1)
    f2 = torch.fft.rfftn(map2.to(torch.float32)).reshape(-1)
    bins = _shell_bins(n, n_bins, map1.device)
    num = _shell_sum((f1 * f2.conj()).real, bins, n_bins)
    d1 = _shell_sum(f1.real ** 2 + f1.imag ** 2, bins, n_bins)
    d2 = _shell_sum(f2.real ** 2 + f2.imag ** 2, bins, n_bins)
    curve = num / torch.clamp(torch.sqrt(d1 * d2), min=1e-12)
    freqs = (torch.arange(n_bins, dtype=torch.float32, device=map1.device)
             + 0.5) * (0.5 / n_bins)
    return freqs, curve


def resolution_at_threshold(freqs, curve, pixel_size, threshold=0.143):
    """First crossing of the threshold -> resolution in Å (linear interp).
    Returns 2*pixel_size (Nyquist) if the curve never drops below it."""
    freqs = torch.as_tensor(freqs, dtype=torch.float32)
    curve = torch.as_tensor(curve, dtype=torch.float32)
    below = curve < threshold
    below[0] = False  # ignore bin 0
    idx = int(torch.argmax(below.to(torch.int32)))
    crossed = bool(below.any())
    i0 = max(idx - 1, 0)
    c0, c1 = curve[i0], curve[idx]
    f0, f1 = freqs[i0], freqs[idx]
    t = torch.clamp((c0 - threshold) / torch.clamp(c0 - c1, min=1e-9),
                    0.0, 1.0)
    f_cross = f0 + t * (f1 - f0) if crossed else torch.tensor(0.5)
    return pixel_size / f_cross


def part_fsc(fsc_masked, fsc_unmasked_rand, randomization_bin: int):
    """High-resolution noise-substitution correction (Chen et al. 2013):
    true FSC = (masked - rand) / (1 - rand) beyond the randomization shell."""
    corrected = (fsc_masked - fsc_unmasked_rand) / torch.clamp(
        1.0 - fsc_unmasked_rand, min=1e-6)
    shells = torch.arange(fsc_masked.shape[0], device=fsc_masked.device)
    return torch.where(shells <= randomization_bin, fsc_masked, corrected)


def fsc_to_ssnr(curve, eps=1e-6):
    """Shell SSNR from FSC of half maps: SSNR = 2 FSC / (1 - FSC)."""
    c = torch.clamp(curve, 0.0, 1.0 - eps)
    return 2.0 * c / (1.0 - c)


def amplitude_correlation_and_dpr(map1, map2, n_bins: int | None = None):
    """Per-shell amplitude correlation and differential phase residual
    (the relion_postprocess --ampl_corr curves). Returns (freqs,
    ampl_corr, dpr_degrees); DPR is the amplitude-weighted RMS phase
    difference per shell."""
    n = map1.shape[-1]
    if n_bins is None:
        n_bins = n // 2
    f1 = torch.fft.rfftn(map1.to(torch.float32)).reshape(-1)
    f2 = torch.fft.rfftn(map2.to(torch.float32)).reshape(-1)
    bins = _shell_bins(n, n_bins, map1.device)
    a1, a2 = f1.abs(), f2.abs()

    def shell_sum(v):
        return _shell_sum(v, bins, n_bins)

    cnt = shell_sum(torch.ones_like(a1))
    m1 = shell_sum(a1) / torch.clamp(cnt, min=1.0)
    m2 = shell_sum(a2) / torch.clamp(cnt, min=1.0)
    num = shell_sum((a1 - m1[bins]) * (a2 - m2[bins]))
    d1 = shell_sum((a1 - m1[bins]) ** 2)
    d2 = shell_sum((a2 - m2[bins]) ** 2)
    ampl_corr = num / torch.clamp(torch.sqrt(d1 * d2), min=1e-12)
    dphi = torch.angle(f1 * f2.conj())            # [-pi, pi]
    w = a1 + a2
    dpr = torch.sqrt(shell_sum(w * dphi ** 2)
                     / torch.clamp(shell_sum(w), min=1e-12))
    freqs = (torch.arange(n_bins, dtype=torch.float32, device=map1.device)
             + 0.5) * (0.5 / n_bins)
    return freqs, ampl_corr, torch.rad2deg(dpr)


def fsc_weights(curve):
    """Cref figure-of-merit filter sqrt(2 FSC / (1 + FSC))."""
    c = torch.clamp(curve, 0.0, 1.0)
    return torch.sqrt(2.0 * c / (1.0 + c))


def radial_shell_filter_3d(vol_shape, shell_values):
    """Expand per-shell values onto a 3D rfft grid."""
    n = vol_shape[-1]
    n_bins = shell_values.shape[-1]
    bins = _shell_bins(n, n_bins, shell_values.device)
    return shell_values[bins].reshape(tuple(vol_shape[:-3])
                                      + (n, n, n // 2 + 1))


def apply_fsc_filter(vol, curve):
    """Filter a volume by the Cref weights derived from its half-map FSC."""
    filt = radial_shell_filter_3d(vol.shape[-3:], fsc_weights(curve))
    return torch.fft.irfftn(torch.fft.rfftn(vol) * filt, s=vol.shape[-3:])
