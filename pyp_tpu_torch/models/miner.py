"""Self-supervised tomogram pattern mining (the MiLoPYP role) — the torch
port of pyp_tpu/models/miner.py.

A small 3D conv encoder, trained contrastively (NT-Xent on two augmented
views of each patch), embeds densely sampled subvolumes; cosine k-means
clusters the embeddings, and each cluster's coordinates and exemplars
form the gallery a user picks target classes from. The random patches,
augmentations and k-means seeds are drawn on the host with the JAX
package's `RandomState` calls, in the same order. `mine_tomogram` cuts
the dense grid's windows on the device (a strided view of the tomogram)
and streams them through the encoder in chunks sized from free memory.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pyp_tpu_torch import as_f32, resolve_device
from pyp_tpu_torch.models import unet
from pyp_tpu_torch.models.unet import Conv, Dense, GroupNorm
from pyp_tpu_torch.utils import get_logger

logger = get_logger("miner")


class Encoder3D(nn.Module):
    """Strided 3D conv encoder -> L2-normalized embedding.
    x: (B, 1, D, H, W)."""

    def __init__(self, features: Sequence[int] = (16, 32, 64),
                 embed_dim: int = 32):
        super().__init__()
        self.features = tuple(features)
        c = 1
        for i, f in enumerate(self.features):
            self.add_module(f"Conv_{i}", Conv(c, f, (3, 3, 3), strides=2))
            self.add_module(f"GroupNorm_{i}", GroupNorm(min(8, f), f))
            c = f
        self.Dense_0 = Dense(c, embed_dim * 2)
        self.Dense_1 = Dense(embed_dim * 2, embed_dim)

    def forward(self, x):
        for i in range(len(self.features)):
            x = getattr(self, f"Conv_{i}")(x)
            x = F.silu(getattr(self, f"GroupNorm_{i}")(x))
        x = x.mean(dim=(2, 3, 4))              # global average pool
        x = self.Dense_1(F.silu(self.Dense_0(x)))
        return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)


class MinerModel(NamedTuple):
    params: dict          # the Encoder3D's state dict (on the CPU)
    patch: int
    embed_dim: int


def _augment(patches, rng):
    """Random flips / in-plane 90-degree rotations / noise (numpy-side)."""
    out = patches.copy()
    B = len(out)
    for ax in (1, 2, 3):
        flip = rng.rand(B) < 0.5
        out[flip] = np.flip(out[flip], axis=ax)
    k = rng.randint(0, 4, B)
    for i in range(B):
        if k[i]:
            out[i] = np.rot90(out[i], k[i], axes=(1, 2))
    out = out + rng.randn(*out.shape).astype(np.float32) * 0.3 * out.std()
    return out


def _normalize(p):
    m = p.mean(axis=(1, 2, 3), keepdims=True)
    s = p.std(axis=(1, 2, 3), keepdims=True)
    return (p - m) / (s + 1e-6)


def _normalize_t(p):
    """_normalize of a (N, p, p, p) tensor."""
    m = p.mean(dim=(1, 2, 3), keepdim=True)
    s = p.std(dim=(1, 2, 3), correction=0, keepdim=True)
    return (p - m) / (s + 1e-6)


def sample_grid_patches(tomogram, patch: int, stride: int):
    """Dense grid of subvolumes + their center coordinates (z, y, x)."""
    nz, ny, nx = tomogram.shape
    coords, wins = [], []
    for z0 in range(0, nz - patch + 1, stride):
        for y0 in range(0, ny - patch + 1, stride):
            for x0 in range(0, nx - patch + 1, stride):
                wins.append(tomogram[z0:z0 + patch, y0:y0 + patch,
                                     x0:x0 + patch])
                coords.append((z0 + patch // 2, y0 + patch // 2,
                               x0 + patch // 2))
    return (np.asarray(wins, dtype=np.float32),
            np.asarray(coords, dtype=np.int32))


def _nt_xent(z1, z2, temperature):
    """NT-Xent over a batch of (view1, view2) pairs: the two views of
    patch i are positives, everything else negatives."""
    z = torch.cat([z1, z2])                          # (2B, E)
    b2 = z.shape[0]
    sim = z @ z.T / temperature
    sim = sim - 1e9 * torch.eye(b2, device=z.device)  # mask self
    b = z1.shape[0]
    ar = torch.arange(b, device=z.device)
    pos = torch.cat([ar + b, ar])
    rows = torch.arange(b2, device=z.device)
    return torch.mean(-sim[rows, pos] + torch.logsumexp(sim, dim=1))


def train_miner(tomograms, patch: int = 16, n_steps: int = 200,
                batch: int = 64, embed_dim: int = 32, lr: float = 1e-3,
                temperature: float = 0.2, seed: int = 0,
                device="cuda") -> MinerModel:
    """Contrastive training (Adam on NT-Xent) on random patches from the
    given tomograms."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    enc = unet.init_params(Encoder3D(embed_dim=embed_dim), seed).to(dev)
    opt = torch.optim.Adam(enc.parameters(), lr=lr)

    def random_patches(n):
        out = []
        for _ in range(n):
            t = tomograms[rng.randint(len(tomograms))]
            nz, ny, nx = t.shape
            z0 = rng.randint(0, nz - patch + 1)
            y0 = rng.randint(0, ny - patch + 1)
            x0 = rng.randint(0, nx - patch + 1)
            out.append(t[z0:z0 + patch, y0:y0 + patch, x0:x0 + patch])
        return np.asarray(out, dtype=np.float32)

    for it in range(n_steps):
        base = random_patches(batch)
        x1 = as_f32(_normalize(_augment(base, rng)), dev)[:, None]
        x2 = as_f32(_normalize(_augment(base, rng)), dev)[:, None]
        loss = _nt_xent(enc(x1), enc(x2), temperature)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if it % 50 == 0:
            logger.info("miner step %d: loss %.4f", it, loss.item())
    return MinerModel(params=unet.cpu_state(enc), patch=patch,
                      embed_dim=embed_dim)


def _encoder(model: MinerModel, dev):
    enc = Encoder3D(embed_dim=model.embed_dim)
    enc.load_state_dict(model.params)
    return enc.to(dev).eval()


def _embed_chunks(enc, n, patch, cut, dev):
    """Embeddings of n windows, `cut(lo, hi)` giving windows [lo, hi) as a
    (k, p, p, p) tensor, in chunks sized from free memory."""
    step = unet.tile_batch(dev, n, patch ** 3, enc.features)
    out = []
    with torch.no_grad():
        for lo in range(0, n, step):
            x = _normalize_t(cut(lo, min(lo + step, n)))[:, None]
            out.append(enc(x))
    return torch.cat(out) if out else torch.zeros(
        (0, enc.Dense_1.kernel.shape[0]), device=dev)


def embed_patches(model: MinerModel, patches, device="cuda"):
    """(N, p, p, p) -> (N, E) L2-normalized embeddings (a tensor on
    `device`), in chunks sized from free memory (the JAX function's
    `batch` of 256)."""
    dev = resolve_device(device)
    x = as_f32(patches, dev)
    return _embed_chunks(_encoder(model, dev), len(x), model.patch,
                         lambda lo, hi: x[lo:hi], dev)


def kmeans(embeddings, k: int, n_iters: int = 30, seed: int = 0):
    """Cosine k-means on L2-normalized embeddings -> (labels, centroids)."""
    z = np.asarray(embeddings, dtype=np.float32)
    rng = np.random.RandomState(seed)
    centroids = z[rng.choice(len(z), size=k, replace=False)]
    for _ in range(n_iters):
        sim = z @ centroids.T                      # cosine similarity
        labels = np.argmax(sim, axis=1)
        for j in range(k):
            members = z[labels == j]
            if len(members):
                c = members.mean(axis=0)
                centroids[j] = c / (np.linalg.norm(c) + 1e-8)
    return labels, centroids


def mine_tomogram(model: MinerModel, tomogram, n_clusters: int = 8,
                  stride: int = None, exemplars_per_cluster: int = 5,
                  device="cuda"):
    """Dense sweep -> embeddings -> clusters; returns a dict per cluster:
    {"coords" (N, 3), "exemplars" (M, 3), "size"} — the miloeval contract
    — with the labels and the grid's centre coordinates (numpy). The grid
    is sample_grid_patches' (z, then y, then x); its windows are cut on
    the device from a strided view of the tomogram."""
    dev = resolve_device(device)
    p = model.patch
    stride = stride or p // 2
    vol = as_f32(tomogram, dev)
    view = vol.unfold(0, p, stride).unfold(1, p, stride).unfold(2, p, stride)
    gz, gy, gx = view.shape[:3]
    iz, iy, ix = (a.reshape(-1) for a in np.meshgrid(
        np.arange(gz), np.arange(gy), np.arange(gx), indexing="ij"))
    coords = np.stack([iz * stride + p // 2, iy * stride + p // 2,
                       ix * stride + p // 2], axis=1).astype(np.int32)
    flat = torch.arange(len(coords), device=dev)

    def cut(lo, hi):
        i = flat[lo:hi]
        return view[i // (gy * gx), (i // gx) % gy, i % gx]

    z = _embed_chunks(_encoder(model, dev), len(coords), p, cut, dev)
    z = z.cpu().numpy()
    labels, centroids = kmeans(z, n_clusters)
    clusters = []
    for j in range(n_clusters):
        idx = np.where(labels == j)[0]
        if not len(idx):
            clusters.append({"coords": np.zeros((0, 3), np.int32),
                             "exemplars": np.zeros((0, 3), np.int32),
                             "size": 0})
            continue
        # exemplars: members closest to the centroid
        order = np.argsort(-(z[idx] @ centroids[j]))
        ex = coords[idx[order[:exemplars_per_cluster]]]
        clusters.append({"coords": coords[idx], "exemplars": ex,
                         "size": int(len(idx))})
    return clusters, labels, coords
