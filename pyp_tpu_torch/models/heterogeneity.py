"""Continuous heterogeneity analysis — a cryoDRGN-style Fourier-slice VAE;
the torch port of pyp_tpu/models/heterogeneity.py.

Given particles with known poses, learn a latent-conditioned neural
volume:

    encoder:  particle image -> q(z | x)            (CNN -> mu, logvar)
    decoder:  (gamma(k), z) -> F_vol(k)             (positional-encoded MLP)

trained by comparing decoded central-slice values at the particle's
pose-rotated frequency points (the refinement's band-limited mask
points) with the particle's measured spectrum, the CTF applied on the
model side. The tilt branch (the tomoDRGN role) pools the per-tilt
posteriors of one particle as a product of Gaussians. Batches of indices
are drawn with the JAX package's `RandomState` calls; the
reparameterization noise comes from a seeded `torch.Generator` on the
device (the JAX package draws it with `jax.random` inside its step, so
the two packages' trainings agree by what they reach, not step by step).

Analysis: embed all particles (chunked from free memory), PCA of the
latent space, decode any z on the full Fourier grid -> real-space
volume.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pyp_tpu_torch import as_f32, resolve_device
from pyp_tpu_torch.core.geometry import euler_to_matrix
from pyp_tpu_torch.models import unet
from pyp_tpu_torch.models.unet import Conv, Dense
from pyp_tpu_torch.ops.fourier_slice import (
    gather_2d_hermitian,
    image_to_fourier,
    slice_points,
)
from pyp_tpu_torch.ops.refine3d import _ctf_at_points, make_mask_points


class Encoder(nn.Module):
    """(B, 1, n, n) -> (mu, logvar), (B, latent_dim) each. The dense head
    flattens channel-last, as flax's NHWC reshape does."""

    def __init__(self, latent_dim: int = 8, n: int = 64):
        super().__init__()
        c, s = 1, n
        for i, f in enumerate((16, 32, 64)):
            self.add_module(f"Conv_{i}", Conv(c, f, (3, 3), strides=2))
            c, s = f, -(-s // 2)
        self.Dense_0 = Dense(s * s * c, 128)
        self.Dense_1 = Dense(128, latent_dim)
        self.Dense_2 = Dense(128, latent_dim)

    def forward(self, x):
        for i in range(3):
            x = F.silu(getattr(self, f"Conv_{i}")(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.silu(self.Dense_0(x))
        return self.Dense_1(x), self.Dense_2(x)


class SliceDecoder(nn.Module):
    """Positional-encoded coordinate MLP: (k, z) -> F_vol(k) (complex)."""

    def __init__(self, latent_dim: int = 8, hidden: int = 128,
                 n_freqs: int = 6):
        super().__init__()
        self.n_freqs = n_freqs
        c = 3 * 2 * n_freqs + 3 + latent_dim
        for i in range(3):
            self.add_module(f"Dense_{i}", Dense(c, hidden))
            c = hidden
        self.Dense_3 = Dense(hidden, 2)

    def forward(self, coords, z):
        # coords: (..., 3) in cycles/pixel (|k| <= 0.5); z: (..., latent)
        scales = (2.0 ** torch.arange(self.n_freqs, dtype=torch.float32,
                                      device=coords.device)) * np.pi * 2.0
        ang = coords[..., None] * scales  # (..., 3, n_freqs)
        lead = coords.shape[:-1]
        h = torch.cat([torch.sin(ang).reshape(*lead, -1),
                       torch.cos(ang).reshape(*lead, -1), coords, z], dim=-1)
        for i in range(3):
            h = F.silu(getattr(self, f"Dense_{i}")(h))
        out = self.Dense_3(h)
        return torch.complex(out[..., 0], out[..., 1])


class HetModel(NamedTuple):
    enc_params: dict      # the Encoder's state dict (on the CPU)
    dec_params: dict      # the SliceDecoder's state dict (on the CPU)
    latent_dim: int
    n: int
    pixel_size: float
    mask_pts: np.ndarray
    hidden: int = 128


def _slice_coords(mask_pts, poses, n):
    """Pose-rotated 3D frequency coords (B, G, 3) xyz in cycles/pixel."""
    R = euler_to_matrix(poses[:, 0], poses[:, 1], poses[:, 2])
    return slice_points(R, mask_pts).flip(-1) / n


def _slice_data(images, poses, ctf_params, mask_pts, n, pixel_size,
                voltage_kv, cs_mm, w):
    """What both trainers compare against, for (N, n, n) images at (N, 5)
    poses and (N, 4) CTF parameters (tensors on one device): the measured
    spectrum at the mask points, shifted to centre the particle and
    normalized per image (N, G); the CTF there (N, G); the pose-rotated
    coordinates (N, G, 3)."""
    pts = mask_pts
    xv = gather_2d_hermitian(image_to_fourier(images), pts)
    # apply recorded shifts so particles are centered
    ph = 2.0 * np.pi * (pts[None, :, 0] * poses[:, 3, None]
                        + pts[None, :, 1] * poses[:, 4, None]) / n
    xv = xv * torch.complex(torch.cos(ph), -torch.sin(ph))
    xv = xv / (torch.sqrt(torch.mean(xv.abs() ** 2, dim=1, keepdim=True))
               + 1e-8)
    cp = ctf_params
    ctf = _ctf_at_points(pts, n, pixel_size, cp[:, 0:1], cp[:, 1:2],
                         cp[:, 2:3], voltage_kv, cs_mm, w, cp[:, 3:4])
    return xv, ctf, _slice_coords(pts, poses, n)


def _standardized(images):
    """Each (n, n) image of a numpy stack to zero mean and unit std, as
    the JAX trainers do on the host."""
    ax = (-2, -1)
    return (images - images.mean(axis=ax, keepdims=True)) / (
        images.std(axis=ax, keepdims=True) + 1e-6)


def _kl(mu, logvar, var):
    return -0.5 * torch.mean(1 + logvar - mu ** 2 - var)


def _het_loss(encoder, decoder, x, coords, ctf, xv, eps, kl_weight):
    """The SPA trainer's loss for one batch: images x (b, 1, n, n), their
    coords (b, G, 3), CTF (b, G) and spectra (b, G), noise eps
    (b, latent)."""
    mu, logvar = encoder(x)
    z = mu + torch.exp(0.5 * logvar) * eps
    G = coords.shape[1]
    zb = z[:, None, :].expand(z.shape[0], G, z.shape[1])
    pred = decoder(coords, zb) * ctf
    recon = torch.mean((pred - xv).abs() ** 2)
    return recon + kl_weight * _kl(mu, logvar, torch.exp(logvar))


def _pool_gaussians(mu, logvar, axis=1):
    """Product of per-view Gaussian posteriors q(z|x_t) -> pooled (mu, var).

    Precision-weighted mean over the tilt axis — the tomoDRGN idea that all
    tilt images of one particle share a single latent, with each view
    contributing evidence proportional to its certainty."""
    prec = torch.exp(-logvar)
    lam = torch.sum(prec, dim=axis)
    mu_p = torch.sum(mu * prec, dim=axis) / torch.clamp(lam, min=1e-8)
    return mu_p, 1.0 / torch.clamp(lam, min=1e-8)


def _het_tilt_loss(encoder, decoder, x, coords, ctf, xv, tw, eps,
                   kl_weight):
    """The tilt trainer's loss for one batch of b particles: tilt images
    x (b, T, n, n), coords (b, T, G, 3), CTF and spectra (b, T, G), tilt
    weights tw (b, T), noise eps (b, latent)."""
    b, T, n, _ = x.shape
    G = coords.shape[2]
    mu_t, lv_t = encoder(x.reshape(b * T, 1, n, n))
    mu, var = _pool_gaussians(mu_t.reshape(b, T, -1), lv_t.reshape(b, T, -1))
    z = mu + torch.sqrt(var) * eps
    L = z.shape[1]
    zb = z[:, None, None, :].expand(b, T, G, L)
    pred = decoder(coords.reshape(b * T, G, 3), zb.reshape(b * T, G, L))
    pred = pred.reshape(b, T, G) * ctf
    resid = (pred - xv).abs() ** 2 * tw[..., None]
    recon = torch.sum(resid) / torch.clamp(torch.sum(tw) * G, min=1.0)
    return recon + kl_weight * _kl(mu, torch.log(var), var)


def _models(latent_dim, n, hidden, seed, dev):
    encoder = unet.init_params(Encoder(latent_dim=latent_dim, n=n), seed)
    decoder = unet.init_params(
        SliceDecoder(latent_dim=latent_dim, hidden=hidden), seed + 1)
    return encoder.to(dev), decoder.to(dev)


def _result(encoder, decoder, hidden, latent_dim, n, pixel_size, mask_pts):
    return HetModel(enc_params=unet.cpu_state(encoder),
                    dec_params=unet.cpu_state(decoder), hidden=hidden,
                    latent_dim=latent_dim, n=n, pixel_size=pixel_size,
                    mask_pts=mask_pts)


def train_heterogeneity(
    stack, poses, ctf_params, pixel_size: float,
    latent_dim: int = 8, steps: int = 500, batch: int = 32,
    lr: float = 1e-3, low_res: float = 60.0, high_res: float = 8.0,
    kl_weight: float = 1e-3, seed: int = 0, hidden: int = 128,
    voltage_kv: float = 300.0, cs_mm: float = 2.7, w: float = 0.07,
    device="cuda",
) -> HetModel:
    """Train the VAE on particles (B, n, n) at poses (B, 5) (phi, theta,
    psi, sy, sx in px) with CTF parameters (B, 4): Adam on the slice
    residual plus kl_weight x KL."""
    dev = resolve_device(device)
    stack = np.asarray(stack, dtype=np.float32)
    B, n, _ = stack.shape
    mask_pts = make_mask_points(n, pixel_size, low_res, high_res)
    rng = np.random.RandomState(seed)
    xv, ctf, coords = _slice_data(
        as_f32(stack, dev), as_f32(poses, dev), as_f32(ctf_params, dev),
        as_f32(mask_pts, dev), n, pixel_size, voltage_kv, cs_mm, w)
    imgs = as_f32(_standardized(stack), dev)[:, None]

    encoder, decoder = _models(latent_dim, n, hidden, seed, dev)
    opt = torch.optim.Adam(list(encoder.parameters())
                           + list(decoder.parameters()), lr=lr)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    for _ in range(steps):
        idx = torch.as_tensor(rng.randint(0, B, min(batch, B)), device=dev)
        eps = torch.randn((len(idx), latent_dim), generator=gen, device=dev)
        loss = _het_loss(encoder, decoder, imgs[idx], coords[idx], ctf[idx],
                         xv[idx], eps, kl_weight)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    return _result(encoder, decoder, hidden, latent_dim, n, pixel_size,
                   mask_pts)


def train_heterogeneity_tilt(
    stacks, poses, ctf_params, pixel_size: float,
    tilt_weights=None,
    latent_dim: int = 8, steps: int = 500, batch: int = 8,
    lr: float = 1e-3, low_res: float = 60.0, high_res: float = 8.0,
    kl_weight: float = 1e-3, seed: int = 0, hidden: int = 128,
    voltage_kv: float = 300.0, cs_mm: float = 2.7, w: float = 0.07,
    device="cuda",
) -> HetModel:
    """tomoDRGN-role trainer: per-particle tilt stacks share one latent.

    stacks (P, T, n, n); poses (P, T, 5) per-tilt (phi, theta, psi, sx,
    sy); ctf_params (P, T, 4); tilt_weights (P, T) optional dose/exposure
    weights on the residuals. The encoder runs per tilt image and the
    per-view posteriors are pooled as a product of Gaussians; the decoder
    is scored on every tilt's central slice."""
    dev = resolve_device(device)
    stacks = np.asarray(stacks, dtype=np.float32)
    P, T, n, _ = stacks.shape
    mask_pts = make_mask_points(n, pixel_size, low_res, high_res)
    G = len(mask_pts)
    rng = np.random.RandomState(seed)
    xv, ctf, coords = _slice_data(
        as_f32(stacks.reshape(P * T, n, n), dev),
        as_f32(np.asarray(poses, np.float32).reshape(P * T, 5), dev),
        as_f32(np.asarray(ctf_params, np.float32).reshape(P * T, 4), dev),
        as_f32(mask_pts, dev), n, pixel_size, voltage_kv, cs_mm, w)
    xv, ctf = xv.reshape(P, T, G), ctf.reshape(P, T, G)
    coords = coords.reshape(P, T, G, 3)
    tw = (torch.ones((P, T), device=dev) if tilt_weights is None
          else as_f32(tilt_weights, dev))
    imgs = as_f32(_standardized(stacks), dev)        # (P, T, n, n)

    encoder, decoder = _models(latent_dim, n, hidden, seed, dev)
    opt = torch.optim.Adam(list(encoder.parameters())
                           + list(decoder.parameters()), lr=lr)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    for _ in range(steps):
        idx = torch.as_tensor(rng.randint(0, P, min(batch, P)), device=dev)
        eps = torch.randn((len(idx), latent_dim), generator=gen, device=dev)
        loss = _het_tilt_loss(encoder, decoder, imgs[idx], coords[idx],
                              ctf[idx], xv[idx], tw[idx], eps, kl_weight)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    return _result(encoder, decoder, hidden, latent_dim, n, pixel_size,
                   mask_pts)


def _encoder(model: HetModel, dev):
    enc = Encoder(latent_dim=model.latent_dim, n=model.n)
    enc.load_state_dict(model.enc_params)
    return enc.to(dev).eval()


def _encode(model: HetModel, images, dev):
    """(mu, logvar) of standardized (N, n, n) images, in chunks sized from
    free memory."""
    enc = _encoder(model, dev)
    x = as_f32(_standardized(np.asarray(images, dtype=np.float32)), dev)
    step = unet.tile_batch(dev, len(x), model.n ** 2, (16, 32, 64))
    mus, lvs = [], []
    with torch.no_grad():
        for lo in range(0, len(x), step):
            mu, lv = enc(x[lo:lo + step, None])
            mus.append(mu)
            lvs.append(lv)
    return torch.cat(mus), torch.cat(lvs)


def embed_tilt(model: HetModel, stacks, device="cuda"):
    """Pooled latent means for tilt stacks (P, T, n, n) -> (P, latent), a
    tensor on `device`."""
    dev = resolve_device(device)
    stacks = np.asarray(stacks, dtype=np.float32)
    P, T, n, _ = stacks.shape
    mu_t, lv_t = _encode(model, stacks.reshape(P * T, n, n), dev)
    mu, _ = _pool_gaussians(mu_t.reshape(P, T, -1), lv_t.reshape(P, T, -1))
    return mu


def embed(model: HetModel, stack, device="cuda"):
    """Latent means for every particle (B, latent_dim), a tensor on
    `device`."""
    dev = resolve_device(device)
    return _encode(model, stack, dev)[0]


def decode_volume(model: HetModel, z, max_k: float = 0.4, device="cuda"):
    """Decode one latent vector on the full Fourier grid -> (n, n, n) map,
    a tensor on `device`."""
    from pyp_tpu_torch.ops.fourier_slice import _freq_checkerboard_3d

    dev = resolve_device(device)
    n = model.n
    decoder = SliceDecoder(latent_dim=model.latent_dim, hidden=model.hidden)
    decoder.load_state_dict(model.dec_params)
    decoder = decoder.to(dev).eval()
    kz = np.fft.fftfreq(n)
    ky = np.fft.fftfreq(n)
    kx = np.fft.rfftfreq(n)
    grid = np.stack(np.meshgrid(kx, ky, kz, indexing="ij"), axis=-1)  # x,y,z order
    grid = np.transpose(grid, (2, 1, 0, 3))  # -> (kz, ky, kx, 3) with xyz comps
    pts = grid.reshape(-1, 3)
    sel = np.linalg.norm(pts, axis=1) <= max_k
    p = as_f32(pts[sel], dev)
    zt = as_f32(np.asarray(z, dtype=np.float32), dev)
    vals = []
    step = unet.tile_batch(dev, len(p), 1, (model.hidden,) * 4)
    with torch.no_grad():
        for lo in range(0, len(p), step):
            chunk = p[lo:lo + step]
            vals.append(decoder(chunk, zt.expand(len(chunk), -1)))
    out = torch.zeros(len(pts), dtype=torch.complex64, device=dev)
    out[torch.as_tensor(np.nonzero(sel)[0], device=dev)] = torch.cat(vals)
    Fv = out.reshape(n, n, n // 2 + 1) * _freq_checkerboard_3d(n, dev)
    return torch.fft.irfftn(Fv, s=(n, n, n), dim=(0, 1, 2))


def latent_pca(latents, n_components: int = 2):
    """PCA of the latent space (the cryoDRGN analyze step)."""
    z = np.asarray(latents, dtype=np.float64)
    zc = z - z.mean(axis=0, keepdims=True)
    u, s, vt = np.linalg.svd(zc, full_matrices=False)
    return zc @ vt[:n_components].T, vt[:n_components], s


def save_model(model: HetModel, path):
    """Checkpoint a trained heterogeneity model, as the JAX package's
    save_model writes it (either package loads it)."""
    from pyp_tpu_torch.models import io as mio

    mio.save_params(
        (model.enc_params, model.dec_params), path,
        hidden=model.hidden, latent_dim=model.latent_dim, n=model.n,
        pixel_size=model.pixel_size, mask_pts=np.asarray(model.mask_pts))
    return str(path)


def load_model(path) -> HetModel:
    """Load a checkpoint saved by save_model in either package."""
    from pyp_tpu_torch.models import io as mio

    with np.load(path) as z:
        meta = {k[6:]: z[k] for k in z.files if k.startswith("_meta_")}
    n = int(meta["n"])
    latent = int(meta["latent_dim"])
    hidden = int(meta["hidden"])
    like = (Encoder(latent_dim=latent, n=n).state_dict(),
            SliceDecoder(latent_dim=latent, hidden=hidden).state_dict())
    (ep, dp), _m = mio.load_params(path, like)
    return HetModel(enc_params=ep, dec_params=dp, hidden=hidden,
                    latent_dim=latent, n=n,
                    pixel_size=float(meta["pixel_size"]),
                    mask_pts=np.asarray(meta["mask_pts"], dtype=np.float32))
