"""FFT helpers — the torch port of pyp_tpu/core/fft.py: frequency grids,
Fourier-space shifts, crop/pad resampling, binning and the rotational
average. Batched over leading axes. Frequencies are in cycles per pixel;
multiply by 1/pixel_size for 1/Å. The energy normalization of the crops
preserves mean intensity."""

from __future__ import annotations

import numpy as np
import torch


def freq_grid_2d(ny: int, nx: int, rfft: bool = True, device=None):
    """(fy, fx) broadcastable frequency grids in cycles/pixel: fy (ny, 1),
    fx (1, nx//2+1) for the rfft layout, else the full fftfreq."""
    kw = dict(dtype=torch.float32, device=device)
    fy = torch.fft.fftfreq(ny, **kw).reshape(ny, 1)
    fx = (torch.fft.rfftfreq(nx, **kw) if rfft
          else torch.fft.fftfreq(nx, **kw)).reshape(1, -1)
    return fy, fx


def radius_grid(ny: int, nx: int, rfft: bool = True, device=None):
    """|f| in cycles/pixel, shape (ny, nx//2+1) or (ny, nx)."""
    fy, fx = freq_grid_2d(ny, nx, rfft, device)
    return torch.sqrt(fy * fy + fx * fx)


def phase_ramp(shift_yx, ny: int, nx: int, rfft: bool = True):
    """exp(-2 pi i (fy sy + fx sx)) for shifts (..., 2) in pixels:
    (..., ny, nxf) complex64 on the shifts' device."""
    fy, fx = freq_grid_2d(ny, nx, rfft, shift_yx.device)
    sy = shift_yx[..., 0][..., None, None]
    sx = shift_yx[..., 1][..., None, None]
    phase = -2.0 * np.pi * (fy * sy + fx * sx)
    return torch.complex(torch.cos(phase), torch.sin(phase))


def fourier_shift(f_img, shift_yx, ny: int, nx: int, rfft: bool = True):
    """Apply a real-space translation as a Fourier phase ramp. f_img:
    (..., ny, nxf) complex spectrum; shift_yx: (..., 2) in pixels (positive
    = shift image content toward +y/+x)."""
    shift_yx = torch.as_tensor(shift_yx, dtype=torch.float32,
                               device=f_img.device)
    return f_img * phase_ramp(shift_yx, ny, nx, rfft)


def shift_images(imgs, shifts_yx):
    """Translate a batch of real images by sub-pixel shifts (periodic)."""
    ny, nx = imgs.shape[-2], imgs.shape[-1]
    f = fourier_shift(torch.fft.rfft2(imgs.to(torch.float32)), shifts_yx,
                      ny, nx)
    return torch.fft.irfft2(f, s=(ny, nx))


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


def bin_images(imgs, binning: int):
    """Integer Fourier binning of a batch of images."""
    ny, nx = imgs.shape[-2], imgs.shape[-1]
    return fourier_crop(imgs, (ny // binning, nx // binning))


def radial_average(power, n_bins: int, ny: int, nx: int, rfft: bool = True):
    """Rotational average of a (batched) 2D spectrum into n_bins radial
    bins. Returns (profile, counts); bin i covers |f| in
    [i, i+1) * (0.5 / n_bins)."""
    r = radius_grid(ny, nx, rfft, power.device)
    bins = torch.clamp((r / 0.5 * n_bins).to(torch.int64), 0,
                       n_bins - 1).reshape(-1)
    counts = torch.zeros(n_bins, device=power.device).index_add_(
        0, bins, torch.ones(bins.shape, device=power.device))
    flat = power.to(torch.float32).reshape(-1, bins.numel())
    sums = torch.zeros(flat.shape[0], n_bins, device=power.device)
    sums.index_add_(1, bins, flat)
    prof = sums / torch.clamp(counts, min=1.0)
    return prof.reshape(power.shape[:-2] + (n_bins,)), counts
