"""Particle extraction: windowed crops + normalization, batched — the torch
port of pyp_tpu/ops/extract.py: window particles out of a micrograph at
given coordinates as one gather, optionally Fourier-downsample, normalize
against the background annulus, and invert contrast; and the subvolume
windows of the local resolution estimate."""

from __future__ import annotations

import torch

from pyp_tpu_torch import as_f32, resolve_device
from pyp_tpu_torch.core.fft import fourier_crop, shift_images
from pyp_tpu_torch.core.filters import soft_circular_mask


def window_particles(micrograph, coords, boxsize: int):
    """Crop boxsize² windows centered on integer coords (N, 2) = (y, x) of
    a 2D tensor.

    Coordinates are clamped so windows stay in bounds (the reference skips
    out-of-bounds boxes; we clamp and let the validity mask upstream decide).
    """
    ny, nx = micrograph.shape
    dev = micrograph.device
    lim = torch.tensor([ny - boxsize, nx - boxsize], device=dev)
    coords = torch.as_tensor(coords, device=dev).to(torch.int64)
    starts = torch.minimum(torch.clamp(coords - boxsize // 2, min=0), lim)
    ar = torch.arange(boxsize, device=dev)
    y = (starts[:, 0, None] + ar)[:, :, None]
    x = (starts[:, 1, None] + ar)[:, None, :]
    return micrograph[y, x]


def extract_particles(
    micrograph,
    coords,
    boxsize: int,
    downsample_to: int | None = None,
    invert: bool = True,
    normalize: bool = True,
    subpixel: bool = False,
    device="cuda",
):
    """Extract, (optionally) Fourier-bin, normalize, and sign-flip particles.

    Normalization: zero mean / unit variance estimated from the corner
    background region outside the particle-radius circle (cisTEM semantics).
    With subpixel=True, float coords are honored: the window is cut at the
    rounded position and the fractional remainder is removed by a Fourier
    phase shift, so the particle lands exactly on the box center.
    Returns (N, s, s) float32 on `device`, s = downsample_to or boxsize.
    """
    dev = resolve_device(device)
    micrograph = as_f32(micrograph, dev)
    if subpixel:
        coords_f = as_f32(coords, dev)
        ci = torch.round(coords_f)
        frac = coords_f - ci
        stack = window_particles(micrograph, ci, boxsize)
        # content sits at +frac from the box center; shift it back
        stack = shift_images(stack, -frac)
    else:
        coords = coords if isinstance(coords, torch.Tensor) else torch.as_tensor(coords)
        stack = window_particles(micrograph, coords.to(dev).to(torch.int64),
                                 boxsize)
    if downsample_to is not None and downsample_to != boxsize:
        stack = fourier_crop(stack, (downsample_to, downsample_to))
        s = downsample_to
    else:
        s = boxsize
    if invert:
        stack = -stack
    if normalize:
        stack = normalize_particles(stack)
    return stack


def normalize_particles(stack):
    """Zero mean and unit variance of each particle's background, the
    region outside 0.375 x the box (a 2 px soft edge): cisTEM's particle
    normalization, on the stack's device."""
    s = stack.shape[-1]
    bg = 1.0 - soft_circular_mask(s, s * 0.375, edge_px=2.0,
                                  device=stack.device)
    wsum = torch.clamp(bg.sum(), min=1.0)
    mu = (stack * bg).sum(dim=(-2, -1), keepdim=True) / wsum
    var = (bg * (stack - mu) ** 2).sum(dim=(-2, -1), keepdim=True) / wsum
    return (stack - mu) / torch.sqrt(torch.clamp(var, min=1e-12))


def extract_from_frames(frames, coords, boxsize: int, shifts=None,
                        device="cuda", **kw):
    """Per-frame extraction for movie/polishing workflows: each particle is
    windowed from every frame (optionally at per-frame drift-corrected
    positions). Returns (N, n_frames, s, s).

    shifts: (n_frames, 2) global drift or (N, n_frames, 2) per-particle
    trajectories (pixels, same convention as motion.align_movie: the shift
    that aligns the frame to the average).
    """
    dev = resolve_device(device)
    frames = as_f32(frames, dev)
    coords = as_f32(coords, dev)
    n_frames = frames.shape[0]
    pos = coords[:, None, :].expand(-1, n_frames, -1)
    if shifts is not None:
        # content of frame f appears at (coord - shift_f); window there
        # ((n_frames, 2) global shifts broadcast over the particles)
        pos = pos - as_f32(shifts, dev)
    posr = torch.round(pos).to(torch.int64)
    return torch.stack([
        extract_particles(frames[f], posr[:, f, :], boxsize, device=dev, **kw)
        for f in range(n_frames)], dim=1)


def subvolume_gather(volume, coords, boxsize: int):
    """Crop boxsize³ subvolumes (N, b, b, b) of a (nz, ny, nx) tensor at
    integer 3D centres coords (N, 3) = (z, y, x); each window is shifted
    to lie inside the volume, as a clamped dynamic slice is."""
    lim = torch.tensor([s - boxsize for s in volume.shape[-3:]],
                       device=volume.device)
    coords = torch.as_tensor(coords, device=volume.device).to(torch.int64)
    starts = torch.minimum(torch.clamp(coords - boxsize // 2, min=0), lim)
    ar = torch.arange(boxsize, device=volume.device)
    z = (starts[:, 0, None] + ar)[:, :, None, None]
    y = (starts[:, 1, None] + ar)[:, None, :, None]
    x = (starts[:, 2, None] + ar)[:, None, None, :]
    return volume[z, y, x]
