"""Masks, the 3D lowpass and image normalization — the torch port of the
parts of pyp_tpu/core/filters.py the refinement slice uses."""

from __future__ import annotations

import numpy as np
import torch


def _smoothstep(x):
    x = torch.clamp(x, 0.0, 1.0)
    return 0.5 - 0.5 * torch.cos(np.pi * x)


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
