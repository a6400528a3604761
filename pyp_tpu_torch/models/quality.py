"""Self-supervised micrograph quality assessment (the prismPYP role) — the
torch port of pyp_tpu/models/quality.py.

Each micrograph becomes a 2-channel image (a bin-averaged real-space
view and its log power spectrum); a small convolutional autoencoder
learns the dataset's appearance; the quality score is the negative
whitened distance of a micrograph's embedding from the dataset's
centroid, so images unlike the bulk (blank ice, drift smear, aberrant
spectra) score low. The scores go into the items' metadata for the
filter mode. Batches of indices are drawn with the JAX package's
`RandomState` calls, in the same order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pyp_tpu_torch import as_f32, resolve_device
from pyp_tpu_torch.models import unet
from pyp_tpu_torch.models.unet import Conv, ConvTranspose, Dense


class QualityAE(nn.Module):
    """x: (B, 2, size, size) -> (latent (B, latent_dim), reconstruction
    cropped to the input's size). The bottleneck flattens channel-last,
    as flax's NHWC reshape does, so carried weights compute the same."""

    def __init__(self, latent_dim: int = 16, size: int = 128):
        super().__init__()
        s = size
        c = 2
        for i, f in enumerate((16, 32, 64)):
            self.add_module(f"Conv_{i}", Conv(c, f, (3, 3), strides=2))
            c, s = f, -(-s // 2)
        self.shape = (s, s, c)                  # NHWC bottleneck
        flat = s * s * c
        self.Dense_0 = Dense(flat, latent_dim)
        self.Dense_1 = Dense(latent_dim, flat)
        for i, f in enumerate((32, 16, 2)):
            self.add_module(f"ConvTranspose_{i}",
                            ConvTranspose(c, f, (3, 3), strides=2))
            c = f

    def forward(self, x):
        s = x.shape[-1]
        h = x
        for i in range(3):
            h = F.silu(getattr(self, f"Conv_{i}")(h))
        z = self.Dense_0(h.permute(0, 2, 3, 1).reshape(h.shape[0], -1))
        h = F.silu(self.Dense_1(z)).reshape((-1,) + self.shape)
        h = h.permute(0, 3, 1, 2)
        for i in range(2):
            h = F.silu(getattr(self, f"ConvTranspose_{i}")(h))
        h = self.ConvTranspose_2(h)
        # conv-transpose stack can overshoot odd sizes; crop to input
        return z, h[:, :, :s, :s]


class QualityModel(NamedTuple):
    params: dict          # the QualityAE's state dict (on the CPU)
    latent_dim: int
    size: int
    mu: np.ndarray        # embedding centroid
    sigma: np.ndarray     # embedding spread (per-dim std)


def featurize(mics, size: int = 128, device="cuda"):
    """Micrographs (M, ny, nx) -> 2-channel (M, 2, size, size) tensor:
    bin-averaged real view + log power spectrum, each standardized."""
    dev = resolve_device(device)
    mics = as_f32(mics, dev)
    M, ny, nx = mics.shape
    by, bx = max(ny // size, 1), max(nx // size, 1)
    cy, cx = size * by, size * bx
    # centred crops, so the fftshifted DC stays at the crop centre when
    # dims aren't multiples of size*bin
    oy, ox = (ny - cy) // 2, (nx - cx) // 2

    def crop_bin(a):
        return a[:, oy:oy + cy, ox:ox + cx].reshape(
            M, size, by, size, bx).mean((2, 4))

    real = crop_bin(mics)
    power = torch.fft.fftshift(torch.fft.fft2(mics).abs() ** 2, dim=(1, 2))
    psc = crop_bin(torch.log(power + 1e-6))

    def std2(a):
        m = a.mean(dim=(1, 2), keepdim=True)
        s = a.std(dim=(1, 2), correction=0, keepdim=True) + 1e-6
        return (a - m) / s

    return torch.stack([std2(real), std2(psc)], dim=1)


def _model(latent_dim, size, params, dev):
    ae = QualityAE(latent_dim=latent_dim, size=size)
    ae.load_state_dict(params)
    return ae.to(dev).eval()


def train_quality(mics, size: int = 128, latent_dim: int = 16,
                  steps: int = 300, batch: int = 16, lr: float = 1e-3,
                  seed: int = 0, momentum: float = 0.0,
                  weight_decay: float = 0.0, log_every: int = 0,
                  device="cuda") -> QualityModel:
    """Self-supervised training on the dataset's own micrographs.

    Adam, or with momentum > 0 SGD with momentum (the reference prism
    trainer's torch default); weight_decay adds the L2 term to the
    gradient ahead of the optimizer (optax's add_decayed_weights chained
    in front, which is torch's coupled weight_decay); log_every mirrors
    prism_train print_freq."""
    dev = resolve_device(device)
    feats = featurize(mics, size, dev)
    M = feats.shape[0]
    ae = unet.init_params(QualityAE(latent_dim=latent_dim, size=size),
                          seed).to(dev)
    if momentum > 0:
        opt = torch.optim.SGD(ae.parameters(), lr=lr, momentum=momentum,
                              weight_decay=weight_decay)
    else:
        opt = torch.optim.Adam(ae.parameters(), lr=lr,
                               weight_decay=weight_decay)
    rng = np.random.RandomState(seed)
    for i in range(steps):
        idx = torch.as_tensor(rng.randint(0, M, min(batch, M)), device=dev)
        x = feats[idx]
        _, rec = ae(x)
        loss = torch.mean((rec - x) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if log_every and (i + 1) % log_every == 0:
            print(f"prism step {i + 1}/{steps}: loss {loss.item():.5f}",
                  flush=True)
    with torch.no_grad():
        z = ae.eval()(feats)[0].cpu().numpy()
    return QualityModel(params=unet.cpu_state(ae), latent_dim=latent_dim,
                        size=size, mu=z.mean(0), sigma=z.std(0) + 1e-6)


def embed_quality(model: QualityModel, mics, device="cuda"):
    """(M, latent_dim) embeddings, a tensor on `device`."""
    dev = resolve_device(device)
    feats = featurize(mics, model.size, dev)
    with torch.no_grad():
        return _model(model.latent_dim, model.size, model.params, dev)(
            feats)[0]


def quality_scores(model: QualityModel, mics, device="cuda"):
    """Per-micrograph quality (numpy): negative whitened distance from the
    dataset centroid, shifted so the dataset median is ~0 (higher = more
    typical = better)."""
    z = embed_quality(model, mics, device).cpu().numpy()
    d = np.linalg.norm((z - model.mu) / model.sigma, axis=1)
    return -(d - np.median(d))
