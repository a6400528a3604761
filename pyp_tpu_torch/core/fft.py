"""FFT crop/pad resampling — the torch port of `fourier_crop` and
`fourier_crop_3d` (pyp_tpu/core/fft.py). Batched over leading axes; the
energy normalization preserves mean intensity."""

from __future__ import annotations

import numpy as np
import torch


def _crop_indices(n_src: int, n_dst: int) -> np.ndarray:
    """FFT-layout index mapping for cropping/padding a full-FFT axis."""
    k_dst = np.fft.fftfreq(n_dst) * n_dst  # integer wavenumbers of dst
    return np.round(k_dst).astype(np.int64) % n_src


def _idx(n_src, n_dst, device):
    return torch.as_tensor(_crop_indices(n_src, n_dst), device=device)


def fourier_crop(imgs, out_shape):
    """Fourier crop (downsample) or pad (upsample) real images (..., ny, nx)
    to out_shape."""
    ny, nx = imgs.shape[-2], imgs.shape[-1]
    oy, ox = out_shape
    f = torch.fft.fft2(imgs.to(torch.float32))
    dev = imgs.device
    if oy <= ny and ox <= nx:
        fc = f[..., _idx(ny, oy, dev), :][..., :, _idx(nx, ox, dev)]
    else:
        fc = torch.zeros(imgs.shape[:-2] + (oy, ox), dtype=f.dtype, device=dev)
        fc[..., _idx(oy, ny, dev)[:, None], _idx(ox, nx, dev)[None, :]] = f
    scale = (oy * ox) / (ny * nx)
    return torch.fft.ifft2(fc).real * scale


def fourier_crop_3d(vol, out_shape):
    """3D Fourier crop/pad of a volume (band-limited resize)."""
    nz, ny, nx = vol.shape[-3:]
    oz, oy, ox = out_shape
    f = torch.fft.fftn(vol.to(torch.float32), dim=(-3, -2, -1))
    dev = vol.device
    if oz <= nz and oy <= ny and ox <= nx:
        fc = f[..., _idx(nz, oz, dev), :, :][..., :, _idx(ny, oy, dev), :]
        fc = fc[..., :, :, _idx(nx, ox, dev)]
    else:
        fc = torch.zeros(vol.shape[:-3] + (oz, oy, ox), dtype=f.dtype,
                         device=dev)
        fc[..., _idx(oz, nz, dev)[:, None, None],
           _idx(oy, ny, dev)[None, :, None],
           _idx(ox, nx, dev)[None, None, :]] = f
    scale = (oz * oy * ox) / (nz * ny * nx)
    return torch.fft.ifftn(fc, dim=(-3, -2, -1)).real * scale
