"""Fourier filters (bandpass, B-factor, motion envelope), masks, the 3D
lowpass and image normalization — the torch port of
pyp_tpu/core/filters.py."""

from __future__ import annotations

import numpy as np
import torch

from pyp_tpu_torch.core.fft import freq_grid_2d, radius_grid


def _smoothstep(x):
    x = torch.clamp(x, 0.0, 1.0)
    return 0.5 - 0.5 * torch.cos(np.pi * x)


def bandpass_filter(shape, low_cut, high_cut, low_width=0.02,
                    high_width=0.02, rfft=True, device=None):
    """Cosine-edged bandpass in cycles/pixel on an FFT-layout grid. Passes
    |f| in [low_cut, high_cut]; each edge rolls off over *_width. low_cut
    <= 0 disables the highpass edge; high_cut >= 0.5*sqrt(2) disables the
    lowpass edge."""
    ny, nx = shape
    r = radius_grid(ny, nx, rfft, device)
    f = torch.ones_like(r)
    if low_cut > 0:
        f = f * _smoothstep((r - (low_cut - low_width)) / max(low_width, 1e-6))
    return f * (1.0 - _smoothstep((r - high_cut) / max(high_width, 1e-6)))


def apply_bandpass(imgs, low_cut, high_cut, **kw):
    ny, nx = imgs.shape[-2], imgs.shape[-1]
    filt = bandpass_filter((ny, nx), low_cut, high_cut, device=imgs.device,
                           **kw)
    return torch.fft.irfft2(torch.fft.rfft2(imgs) * filt, s=(ny, nx))


def bfactor_filter(shape, pixel_size, bfactor, rfft=True, device=None):
    """exp(-B g² / 4) envelope (B in Å²; sharpening for B < 0)."""
    ny, nx = shape
    r = radius_grid(ny, nx, rfft, device) / pixel_size
    return torch.exp(-0.25 * bfactor * r * r)


def motion_envelope(shape, pixel_size, shift_per_frame, rfft=True):
    """Per-frame motion-blur envelope: sinc attenuation from intra-frame
    drift. shift_per_frame: (n_frames, 2) tensor, the drift during each
    frame in pixels. Returns (n_frames, ny, nxf) envelopes."""
    ny, nx = shape
    fy, fx = freq_grid_2d(ny, nx, rfft, shift_per_frame.device)
    dot = (fy[None] * shift_per_frame[:, 0, None, None]
           + fx[None] * shift_per_frame[:, 1, None, None])
    return torch.sinc(dot)


def lowpass_filter_3d(vol, pixel_size, resolution, width=0.01):
    """Cosine lowpass of a volume to the given resolution (Å)."""
    nz, ny, nx = vol.shape[-3:]
    kw = dict(dtype=torch.float32, device=vol.device)
    fz = torch.fft.fftfreq(nz, **kw).reshape(nz, 1, 1)
    fy = torch.fft.fftfreq(ny, **kw).reshape(1, ny, 1)
    fx = torch.fft.rfftfreq(nx, **kw).reshape(1, 1, -1)
    r = torch.sqrt(fz * fz + fy * fy + fx * fx)
    cut = pixel_size / resolution
    filt = 1.0 - _smoothstep((r - cut) / width)
    f = torch.fft.rfftn(vol, dim=(-3, -2, -1))
    return torch.fft.irfftn(f * filt, s=(nz, ny, nx), dim=(-3, -2, -1))


def soft_spherical_mask(n: int, radius_px: float, edge_px: float = 5.0,
                        device="cpu"):
    """3D soft-edged spherical mask of box size n (center at n//2)."""
    ax = torch.arange(n, device=device, dtype=torch.float32) - n // 2
    r = torch.sqrt(ax[:, None, None] ** 2 + ax[None, :, None] ** 2
                   + ax[None, None, :] ** 2)
    return 1.0 - _smoothstep((r - radius_px) / max(edge_px, 1e-6))


def soft_circular_mask(n: int, radius_px: float, edge_px: float = 5.0,
                       device="cpu"):
    ax = torch.arange(n, device=device, dtype=torch.float32) - n // 2
    r = torch.sqrt(ax[:, None] ** 2 + ax[None, :] ** 2)
    return 1.0 - _smoothstep((r - radius_px) / max(edge_px, 1e-6))


def normalize_images(imgs, mask=None, eps=1e-8):
    """Zero-mean / unit-variance normalization per image (optionally with
    statistics from outside the mask, like cisTEM's normalize)."""
    dims = (-2, -1)
    if mask is None:
        mu = imgs.mean(dim=dims, keepdim=True)
        sd = imgs.std(dim=dims, keepdim=True, correction=0)
    else:
        w = 1.0 - mask  # background region
        wsum = torch.clamp(w.sum(), min=eps)
        mu = (imgs * w).sum(dim=dims, keepdim=True) / wsum
        var = (w * (imgs - mu) ** 2).sum(dim=dims, keepdim=True) / wsum
        sd = torch.sqrt(var)
    return (imgs - mu) / torch.clamp(sd, min=eps)
