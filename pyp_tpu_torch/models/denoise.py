"""Noise2noise denoising for micrographs and tomograms, and the
missing-wedge restorer — the torch port of pyp_tpu/models/denoise.py.

A U-Net learns to map one noisy realization to another (for tomograms
the even/odd half reconstructions, for micrographs the even/odd frame
averages); the wedge restorer (the IsoNet role) learns, self-supervised
on (z, x) slices, to fill the missing-wedge sector while a hard Fourier
projection keeps every measured frequency. Training batches are drawn
on the host with the JAX package's `RandomState` calls (and its
`scipy.ndimage.rotate`), in the same order; inference batches every
tile and slice on the device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from pyp_tpu_torch import as_f32, resolve_device
from pyp_tpu_torch.models import unet


class DenoiseModel(NamedTuple):
    params: dict          # the UNet2D's state dict; for the wedge
    patch: int            # restorer {"net", "tilt_max", "final_loss"}


def _cosine_decay(lr: float, steps: int, alpha: float, count: int) -> float:
    """optax.cosine_decay_schedule(lr, steps, alpha) at step `count`."""
    count = min(count, steps)
    cos = 0.5 * (1.0 + math.cos(math.pi * count / steps))
    return lr * ((1.0 - alpha) * cos + alpha)


def _sample_pairs(a_slices, b_slices, patch, batch, rng):
    """One noise2noise batch as the JAX trainer draws it: (input, target)
    (batch, 1, patch, patch) numpy arrays, both scaled by the input's
    statistics."""
    xs, ys = [], []
    for _ in range(batch):
        i = rng.randint(len(a_slices))
        img_a, img_b = a_slices[i], b_slices[i]
        if rng.rand() < 0.5:
            img_a, img_b = img_b, img_a
        ny, nx = img_a.shape
        y0 = rng.randint(0, max(ny - patch, 0) + 1)
        x0 = rng.randint(0, max(nx - patch, 0) + 1)
        xs.append(img_a[y0:y0 + patch, x0:x0 + patch])
        ys.append(img_b[y0:y0 + patch, x0:x0 + patch])
    x = np.stack(xs)[:, None]
    y = np.stack(ys)[:, None]
    mu = x.mean(axis=(2, 3), keepdims=True)
    sd = x.std(axis=(2, 3), keepdims=True) + 1e-6
    return (x - mu) / sd, (y - mu) / sd


def train_denoiser(
    noisy_a, noisy_b, patch: int = 64, steps: int = 300, batch: int = 16,
    lr: float = 3e-4, seed: int = 0, features=(16, 32, 64),
    lr_finish: float = 0.0, device="cuda",
) -> DenoiseModel:
    """noisy_a/noisy_b: lists of paired 2D images (or 3D volumes treated as
    z-stacks of 2D slices) with independent noise of the same signal.
    Adam; with lr_finish > 0 the learning rate decays from lr to lr_finish
    on optax's cosine schedule."""
    dev = resolve_device(device)
    a_slices, b_slices = [], []
    for a, b in zip(noisy_a, noisy_b):
        a = np.asarray(a, dtype=np.float32)
        b = np.asarray(b, dtype=np.float32)
        if a.ndim == 3:
            a_slices.extend(a)
            b_slices.extend(b)
        else:
            a_slices.append(a)
            b_slices.append(b)

    rng = np.random.RandomState(seed)
    net = unet.init_params(unet.UNet2D(features=features, out_channels=1),
                           seed).to(dev)
    opt = torch.optim.Adam(net.parameters(), lr=lr)
    decay = bool(lr_finish and lr_finish > 0)
    for i in range(steps):
        if decay:
            # cosine decay from lr to lr_finish over the run (reference
            # tomo_denoise learningrate_start/finish cards)
            for group in opt.param_groups:
                group["lr"] = _cosine_decay(lr, max(steps, 1),
                                            lr_finish / lr, i)
        x, y = _sample_pairs(a_slices, b_slices, patch, batch, rng)
        x, y = as_f32(x, dev), as_f32(y, dev)
        loss = torch.mean((net(x) - y) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    return DenoiseModel(params=unet.cpu_state(net), patch=patch)


def _denoise_slices(model: DenoiseModel, imgs, features, dev):
    """Each (H, W) image of (N, H, W), standardized on its own, through
    the tiled network, and scaled back."""
    mu = imgs.mean(dim=(-2, -1), keepdim=True)
    sd = imgs.std(dim=(-2, -1), correction=0, keepdim=True) + 1e-6
    out = unet.apply_tiled(unet.loaded_unet(model.params, features, dev),
                           (imgs - mu) / sd, model.patch, features)
    return out * sd + mu


def denoise_image(model: DenoiseModel, image, features=(16, 32, 64),
                  device="cuda"):
    """Tiled inference with overlap blending; preserves input scale.
    Returns a tensor on `device`."""
    dev = resolve_device(device)
    return _denoise_slices(model, as_f32(image, dev)[None], features, dev)[0]


def denoise_tomogram(model: DenoiseModel, tomogram, device="cuda"):
    """denoise_image of every z slice (the default widths), all slices'
    tiles batched together."""
    dev = resolve_device(device)
    return _denoise_slices(model, as_f32(tomogram, dev), (16, 32, 64), dev)


# ---------------------------------------------------------------- isonet
# Missing-wedge restoration. For a single-axis tilt series about the y
# axis the missing wedge occupies a fixed sector of every (kz, kx) plane,
# identically for all y — so restoration is a 2D problem on (z, x) slices
# and reuses UNet2D.


def _wedge_angles(nz, nx, dev):
    """Angle (degrees) of every rfft (kz, kx) frequency from the kx axis,
    in float32 as the JAX package computes it; and the DC mask."""
    kz = torch.as_tensor(np.fft.fftfreq(nz).astype(np.float32),
                         device=dev).reshape(-1, 1)
    kx = torch.as_tensor(np.fft.rfftfreq(nx).astype(np.float32),
                         device=dev).reshape(1, -1)
    ang = torch.rad2deg(torch.atan2(kz.abs().expand(-1, kx.shape[1]),
                                    kx.abs().expand(kz.shape[0], -1)))
    return ang, (kz == 0) & (kx == 0)


def wedge_filter_2d(img_zx, tilt_max_deg: float, device="cuda"):
    """Zero the missing-wedge sector of (z, x) slices (..., nz, nx):
    frequencies whose direction is closer to the z axis than
    (90 - tilt_max) degrees were never measured by any tilt in
    [-tilt_max, tilt_max]."""
    dev = resolve_device(device)
    img = as_f32(img_zx, dev)
    nz, nx = img.shape[-2:]
    ang, dc = _wedge_angles(nz, nx, dev)
    keep = (ang <= tilt_max_deg) | dc
    return torch.fft.irfft2(torch.fft.rfft2(img) * keep, s=(nz, nx))


def wedge_filter_3d(vol, tilt_max_deg: float, device="cuda"):
    """Apply the single-axis missing wedge to a (z, y, x) volume (tilt axis
    = y): the 2D wedge over every y slice."""
    dev = resolve_device(device)
    slices = as_f32(vol, dev).transpose(0, 1)          # (y, z, x)
    return wedge_filter_2d(slices, tilt_max_deg, dev).transpose(0, 1)


def _wedge_mask(shape, tilt_max_deg: float, device="cuda"):
    """The missing sector of an rfft (nz, nx) plane (DC excluded)."""
    dev = resolve_device(device)
    ang, dc = _wedge_angles(shape[0], shape[1], dev)
    return (ang > tilt_max_deg) & ~dc


def _wedge_batch(slices, patch, batch, rng):
    """Targets for one restorer step as the JAX trainer draws them: each a
    random (z, x) slice turned by a random in-plane angle (scipy, on the
    host), a patch cut from it, standardized. (batch, patch, patch)."""
    import scipy.ndimage as ndi

    ys = []
    for _ in range(batch):
        s = slices[rng.randint(len(slices))]
        rot = ndi.rotate(s, rng.uniform(0, 360), reshape=False,
                         order=1, mode="reflect")
        nz, nx = rot.shape
        z0 = rng.randint(0, max(nz - patch, 0) + 1)
        x0 = rng.randint(0, max(nx - patch, 0) + 1)
        ys.append(rot[z0:z0 + patch, x0:x0 + patch])
    y = np.stack(ys)
    mu = y.mean(axis=(1, 2), keepdims=True)
    sd = y.std(axis=(1, 2), keepdims=True) + 1e-6
    return (y - mu) / sd


def train_wedge_restorer(
    subvols, tilt_max_deg: float, patch: int = 32, steps: int = 300,
    batch: int = 16, lr: float = 1e-3, seed: int = 0, features=(16, 32),
    device="cuda",
) -> DenoiseModel:
    """Self-supervised missing-wedge restorer on (z, x) slices.

    subvols: list of (z, y, x) subvolumes cut from a wedge-limited
    tomogram. Each training sample: a random (z, x) slice rotated by a
    random in-plane angle (target) and the same slice with the axis wedge
    re-applied (input). The network predicts only the missing-sector
    residual; the measured sector is passed through by a hard Fourier
    projection, so the identity mapping is not a solution."""
    dev = resolve_device(device)
    slices = []
    for v in subvols:
        v = np.asarray(v, dtype=np.float32)
        slices.extend(np.moveaxis(v, 1, 0))  # (z, x) planes
    rng = np.random.RandomState(seed)
    net = unet.init_params(unet.UNet2D(features=features, out_channels=1),
                           seed).to(dev)
    opt = torch.optim.Adam(net.parameters(), lr=lr)
    mask = _wedge_mask((patch, patch), tilt_max_deg, dev)
    last = None
    for _ in range(steps):
        y = as_f32(_wedge_batch(slices, patch, batch, rng), dev)
        x = wedge_filter_2d(y, tilt_max_deg, dev)
        raw = net(x[:, None])[:, 0]
        fill = torch.fft.irfft2(torch.fft.rfft2(raw) * mask, s=(patch, patch))
        last = torch.mean((x + fill - y) ** 2)
        opt.zero_grad(set_to_none=True)
        last.backward()
        opt.step()
    return DenoiseModel(
        params={"net": unet.cpu_state(net), "tilt_max": tilt_max_deg,
                "final_loss": last.item() if last is not None else None},
        patch=patch)


def restore_wedge(model: DenoiseModel, tomogram, features=(16, 32),
                  device="cuda"):
    """Apply a trained wedge restorer to a full (z, y, x) tomogram: per
    (z, x) slice (batched over y), the net's prediction projected onto the
    missing sector and added to the input — measured frequencies are
    preserved exactly. Returns a tensor on `device`."""
    dev = resolve_device(device)
    net = unet.loaded_unet(model.params["net"], features, dev)
    vol = as_f32(tomogram, dev)
    nz, ny, nx = vol.shape
    mask = _wedge_mask((nz, nx), model.params["tilt_max"], dev)
    out = torch.empty_like(vol)
    step = unet.tile_batch(dev, ny, nz * nx, features)
    with torch.no_grad():
        for lo in range(0, ny, step):
            sl = vol[:, lo:lo + step].transpose(0, 1)     # (b, z, x)
            mu = sl.mean(dim=(1, 2), keepdim=True)
            sd = sl.std(dim=(1, 2), correction=0, keepdim=True) + 1e-6
            raw = net(((sl - mu) / sd)[:, None])[:, 0]
            fill = torch.fft.irfft2(torch.fft.rfft2(raw) * mask, s=(nz, nx))
            out[:, lo:lo + step] = (sl + fill * sd).transpose(0, 1)
    return out
