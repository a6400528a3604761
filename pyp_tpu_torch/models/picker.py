"""Learned particle picker: heatmap-regression U-Net — the torch port of
pyp_tpu/models/picker.py.

Trains on (micrograph patch, Gaussian-disk heatmap at labeled centres)
pairs, infers a full-micrograph heatmap and picks its peaks. The batches
are drawn with the JAX package's `np.random.RandomState` calls, in the
same order, so one seed gives both packages the same patches.
Inference pushes every tile of a micrograph (or of every slice of a
tomogram) through the network in batches on the device
(`unet.apply_tiled`), where the JAX package runs one tile per call.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pyp_tpu_torch import as_f32, resolve_device
from pyp_tpu_torch.models import unet
from pyp_tpu_torch.models.unet import UNet2D


class PickerModel(NamedTuple):
    params: dict          # the UNet2D's state dict (on the CPU)
    patch: int
    radius_px: float


def make_heatmap(shape, coords, radius_px):
    """Gaussian-disk target heatmap for labeled particle centers."""
    ny, nx = shape
    heat = np.zeros((ny, nx), dtype=np.float32)
    yy, xx = np.mgrid[0:ny, 0:nx]
    for y, x in coords:
        heat = np.maximum(
            heat,
            np.exp(-((yy - y) ** 2 + (xx - x) ** 2) / (2 * (radius_px / 2) ** 2)),
        )
    return heat


def _heatmap_on(shape, coords, radius_px, dev):
    """make_heatmap on `dev`: the same float64 arithmetic, one particle at
    a time over the whole image (the host version takes minutes for a
    4096² micrograph of a few hundred particles)."""
    ny, nx = shape
    yy = torch.arange(ny, dtype=torch.float64, device=dev)[:, None]
    xx = torch.arange(nx, dtype=torch.float64, device=dev)[None, :]
    heat = torch.zeros((ny, nx), dtype=torch.float64, device=dev)
    for y, x in np.asarray(coords, dtype=np.float64).reshape(-1, 2):
        heat = torch.maximum(heat, torch.exp(
            -((yy - y) ** 2 + (xx - x) ** 2) / (2 * (radius_px / 2) ** 2)))
    return heat


def _patch_origins(micrographs, patch, n_patches, rng):
    """(micrograph, y0, x0) of a batch of patches, drawn as the JAX
    package draws them."""
    out = []
    for _ in range(n_patches):
        m = rng.randint(len(micrographs))
        ny, nx = micrographs[m].shape
        y0 = rng.randint(0, ny - patch + 1)
        x0 = rng.randint(0, nx - patch + 1)
        out.append((m, y0, x0))
    return out


def _normalized_patches(micrographs, origins, patch):
    """The micrograph patches at `origins`, each normalized: (n, 1,
    patch, patch) numpy."""
    x = np.stack([micrographs[m][y0:y0 + patch, x0:x0 + patch]
                  for m, y0, x0 in origins])[:, None]
    return (x - x.mean(axis=(2, 3), keepdims=True)) / (
        x.std(axis=(2, 3), keepdims=True) + 1e-6)


def _sample_patches(micrographs, heatmaps, patch, n_patches, rng):
    """A batch of normalized micrograph patches and their heatmaps,
    (n, 1, patch, patch) numpy arrays each, drawn as the JAX package
    draws them."""
    origins = _patch_origins(micrographs, patch, n_patches, rng)
    y = np.stack([heatmaps[m][y0:y0 + patch, x0:x0 + patch]
                  for m, y0, x0 in origins])[:, None]
    # the heatmap is float64; the JAX package's batch is float32
    return (_normalized_patches(micrographs, origins, patch),
            y.astype(np.float32))


def train_picker(
    micrographs, coords_per_micrograph, radius_px: float,
    patch: int = 128, steps: int = 300, batch: int = 16,
    lr: float = 3e-4, seed: int = 0, features=(16, 32, 64), device="cuda",
) -> PickerModel:
    """Train from labeled micrographs (the sprtrain entry): Adam on the
    positive-weighted squared error of the sigmoid heatmap. The target
    heatmaps are made and cut on the device; the micrograph patches are
    cut and normalized on the host, as the JAX package does."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    heatmaps = [_heatmap_on(m.shape, c, radius_px, dev)
                for m, c in zip(micrographs, coords_per_micrograph)]
    net = unet.init_params(UNet2D(features=features, out_channels=1), seed)
    net = net.to(dev)
    opt = torch.optim.Adam(net.parameters(), lr=lr)
    for _ in range(steps):
        origins = _patch_origins(micrographs, patch, batch, rng)
        x = as_f32(_normalized_patches(micrographs, origins, patch), dev)
        y = torch.stack([heatmaps[m][y0:y0 + patch, x0:x0 + patch]
                         for m, y0, x0 in origins])[:, None].float()
        # weighted BCE-ish: emphasize positives
        w = 1.0 + 9.0 * y
        loss = torch.mean(w * (torch.sigmoid(net(x)) - y) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    return PickerModel(params=unet.cpu_state(net), patch=patch,
                       radius_px=radius_px)


def _standardize(imgs):
    """Each (H, W) image of (N, H, W) to zero mean and unit std."""
    mu = imgs.mean(dim=(-2, -1), keepdim=True)
    sd = imgs.std(dim=(-2, -1), correction=0, keepdim=True)
    return (imgs - mu) / (sd + 1e-6)


def infer_heatmap(model: PickerModel, micrograph, features=(16, 32, 64),
                  device="cuda"):
    """Full-micrograph heatmap (a tensor on `device`) via tiled inference
    with overlap blending."""
    dev = resolve_device(device)
    mic = _standardize(as_f32(micrograph, dev)[None])
    return unet.apply_tiled(unet.loaded_unet(model.params, features, dev), mic,
                            model.patch, features, post=torch.sigmoid)[0]


def pick_from_heatmap(heat, radius_px, threshold: float = 0.3,
                      max_picks: int = 1024, device="cuda"):
    """Peaks of the heatmap with NMS — same contract as ops.pick. Returns
    (coords (max_picks, 2) (y, x), values, valid) tensors; of equal
    values the lowest indices are kept, in rising order, as `lax.top_k`
    gives them."""
    from pyp_tpu_torch.ops.pick import _local_maxima

    dev = resolve_device(device)
    h = as_f32(heat, dev)
    is_max = _local_maxima(h, int(radius_px))
    cand = torch.where(is_max & (h > threshold), h, -torch.inf).reshape(-1)
    # a stable sort of the whole map: among equal values the lowest
    # indices are kept, and come first (torch.topk picks any of them)
    vals, idx = torch.sort(cand, descending=True, stable=True)
    vals, idx = vals[:max_picks], idx[:max_picks]
    nx = h.shape[-1]
    coords = torch.stack([idx // nx, idx % nx], dim=1)
    return coords, vals, torch.isfinite(vals)


def pick_tomogram(model: PickerModel, tomogram, radius_px,
                  threshold: float = 0.3, max_picks: int = 512,
                  device="cuda"):
    """3D picking: per-slab 2D heatmaps (every slice's tiles batched) +
    3D NMS (tomoeval equivalent). The network has infer_heatmap's default
    widths, as in the JAX package."""
    from pyp_tpu_torch.ops.template_match import pick_peaks_3d

    dev = resolve_device(device)
    features = (16, 32, 64)
    vol = _standardize(as_f32(tomogram, dev))
    heats = unet.apply_tiled(unet.loaded_unet(model.params, features, dev), vol,
                             model.patch, features, post=torch.sigmoid)
    return pick_peaks_3d(heats, max_picks, int(radius_px), threshold)
