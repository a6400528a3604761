"""Subvolume extraction — the torch port of the one function of
pyp_tpu/ops/extract.py the SPA back half uses: the windows of the local
resolution estimate."""

from __future__ import annotations

import torch


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
