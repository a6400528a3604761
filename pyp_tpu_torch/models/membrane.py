"""Membrane segmentation for tomograms — the MemBrain-seg role; the
torch port of pyp_tpu/models/membrane.py.

A 2D U-Net trained per slice on procedurally generated membranes (closed
contours with low-order radial harmonics, sometimes an open sheet,
rendered as dark ridges into correlated noise with slow illumination
gradients); no external weights. The synthetic batches are drawn on the
host with the JAX package's `RandomState` calls, in the same order.
Inference runs the tomogram's z slices through the network in batches
sized from the card's free memory and returns a membrane probability
volume; `detect_virions_from_segmentation` runs the sphere detector on
it, so `tomo_vir_method=nn` slots into the virion pipeline.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from pyp_tpu_torch import as_f32, resolve_device
from pyp_tpu_torch.models import unet


class MembraneModel(NamedTuple):
    params: dict          # the UNet2D's state dict (on the CPU)
    features: tuple = (16, 32, 64)


def _synth_batch(rng, batch: int, n: int, thickness_px=(2.0, 5.0)):
    """Synthetic (image, mask) slice pairs: each sample draws 1-3 closed
    contours (circle radius + low-order angular harmonics) and sometimes an
    open sheet; membrane = dark ridge of the drawn thickness; background =
    correlated noise + slow illumination gradients."""
    yy, xx = np.mgrid[:n, :n].astype(np.float32)
    imgs = np.zeros((batch, n, n), np.float32)
    masks = np.zeros((batch, n, n), np.float32)
    for b in range(batch):
        dist = np.full((n, n), 1e9, np.float32)
        for _ in range(rng.randint(1, 4)):
            cy, cx = rng.uniform(0.2 * n, 0.8 * n, 2)
            r0 = rng.uniform(0.1 * n, 0.35 * n)
            th = np.arctan2(yy - cy, xx - cx)
            r = np.hypot(yy - cy, xx - cx)
            wob = sum(rng.uniform(-0.08, 0.08) * r0
                      * np.cos(k * th + rng.uniform(0, 2 * np.pi))
                      for k in (2, 3, 4))
            dist = np.minimum(dist, np.abs(r - (r0 + wob)))
        if rng.rand() < 0.3:  # open sheet: a gently curved line
            t = np.linspace(0, 1, n).astype(np.float32)
            y0, y1 = rng.uniform(0, n, 2)
            amp = rng.uniform(-0.2 * n, 0.2 * n)
            path_y = y0 + (y1 - y0) * t + amp * np.sin(np.pi * t)
            d_line = np.abs(yy - path_y[None, :])
            dist = np.minimum(dist, d_line)
        t_px = rng.uniform(*thickness_px)
        ridge = np.exp(-0.5 * (dist / t_px) ** 2)
        mask = (dist < 1.5 * t_px).astype(np.float32)
        # correlated background: white noise blurred in Fourier
        noise = rng.randn(n, n).astype(np.float32)
        k = np.fft.rfftfreq(n)[None, :] ** 2 + np.fft.fftfreq(n)[:, None] ** 2
        noise = np.fft.irfft2(np.fft.rfft2(noise)
                              * np.exp(-k * (2.0 * n)), s=(n, n))
        noise = noise / (noise.std() + 1e-6)
        grad = (rng.uniform(-1, 1) * (yy / n - 0.5)
                + rng.uniform(-1, 1) * (xx / n - 0.5))
        contrast = rng.uniform(0.8, 2.5)
        imgs[b] = (-contrast * ridge + noise
                   + grad + 0.6 * rng.randn(n, n))
        masks[b] = mask
    mu = imgs.mean(axis=(1, 2), keepdims=True)
    sd = imgs.std(axis=(1, 2), keepdims=True) + 1e-6
    return (imgs - mu) / sd, masks


def _bce_loss(logits, y):
    """The positive-weighted, clipped binary cross-entropy of the JAX
    trainer (membranes are sparse: positives weigh 5)."""
    z = torch.clamp(logits, -30, 30)
    bce = torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(-z.abs()))
    return torch.mean((1.0 + 4.0 * y) * bce)


def train_membrane_segmenter(steps: int = 400, batch: int = 16,
                             patch: int = 96, lr: float = 1e-3,
                             seed: int = 0, features=(16, 32, 64),
                             device="cuda") -> MembraneModel:
    """Train the per-slice segmenter on procedural membranes (Adam on the
    weighted BCE)."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    net = unet.init_params(unet.UNet2D(features=tuple(features),
                                       out_channels=1), seed).to(dev)
    opt = torch.optim.Adam(net.parameters(), lr=lr)
    for _ in range(int(steps)):
        x, y = _synth_batch(rng, batch, patch)
        loss = _bce_loss(net(as_f32(x, dev)[:, None])[:, 0], as_f32(y, dev))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    return MembraneModel(params=unet.cpu_state(net), features=tuple(features))


def segment_tomogram(model: MembraneModel, tomogram, batch=None,
                     device="cuda"):
    """Per-slice membrane probability volume (nz, ny, nx) in [0, 1], a
    tensor on `device`. Each slice is standardized on its own and
    reflect-padded to the U-Net's stride multiple; `batch` slices go
    through the network at once (None: as many as the card's free memory
    holds)."""
    dev = resolve_device(device)
    features = tuple(model.features)
    vol = as_f32(tomogram, dev)
    nz, ny, nx = vol.shape
    s = 2 ** (len(features) - 1)
    py, px = (-ny) % s, (-nx) % s
    net = unet.loaded_unet(model.params, features, dev)
    step = batch or unet.tile_batch(dev, nz, (ny + py) * (nx + px), features)
    out = torch.empty_like(vol)
    with torch.no_grad():
        for lo in range(0, nz, step):
            sl = vol[lo:lo + step]
            mu = sl.mean(dim=(1, 2), keepdim=True)
            sd = sl.std(dim=(1, 2), correction=0, keepdim=True) + 1e-6
            x = F.pad(((sl - mu) / sd)[:, None], (0, px, 0, py),
                      mode="reflect")
            out[lo:lo + step] = torch.sigmoid(net(x))[:, 0, :ny, :nx]
    return out


def detect_virions_from_segmentation(prob, radii_px, n_peaks: int = 8,
                                     device="cuda"):
    """Virion seeds from the probability map: the sphere detector
    (template_match.detect_spheres) on the segmentation instead of the raw
    tomogram. Returns (centers, radii, scores, valid) tensors."""
    from pyp_tpu_torch.ops.template_match import detect_spheres

    # membranes are BRIGHT in the probability map: no contrast inversion
    return detect_spheres(prob, radii_px, n_peaks=n_peaks, invert=False,
                          device=device)
