"""Fourier-gridding insertion reconstruction — the torch port of
pyp_tpu/ops/reconstruct.py (the reconstruct3d/merge3d equivalents).

Particle spectra are shift-corrected, CTF-weighted and spread onto the
central slice of a 3D Fourier accumulator pair (numerator, CTF^2
denominator) per half set; shards accumulate independently and merge by
summation. The Wiener-regularized quotient with trilinear gridding
correction gives the half maps, their FSC, and the FSC-filtered combined
map.

Not ported yet (they raise NotImplementedError): dose weighting (`doses`),
likelihood blurring (`lblur`) and Ewald-sphere insertion (`iewald` != 0).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pyp_tpu_torch import resolve_device
from pyp_tpu_torch.core import fsc as fsc_mod
from pyp_tpu_torch.core.fft import fourier_crop
from pyp_tpu_torch.core.geometry import apply_symmetry_matrices, euler_to_matrix
from pyp_tpu_torch.ops.fourier_slice import (
    DEFAULT_PAD,
    _wavenumbers,
    image_to_fourier,
    insert_slices_halves,
    reconstruct_from_accumulators,
)
from pyp_tpu_torch.ops.refine3d import _ctf_at_points


class Accumulators(NamedTuple):
    num1: torch.Tensor  # (pn, pn, pn//2+1) complex — half 1 numerator
    den1: torch.Tensor  # (pn, pn, pn//2+1) real
    num2: torch.Tensor
    den2: torch.Tensor


class Reconstruction(NamedTuple):
    volume: torch.Tensor      # combined map (n, n, n)
    half1: torch.Tensor
    half2: torch.Tensor
    fsc: torch.Tensor         # (n_shells,)
    freqs: torch.Tensor       # shell centers (cycles/pixel)


def _ctf_grids(n, pixel_size, ctf_params, voltage_kv, cs_mm, w):
    """Full-plane CTF images for a batch of particles: (B, n, n//2+1)."""
    ky, kx = _wavenumbers(n, ctf_params.device)
    pts = torch.stack(torch.meshgrid(ky, kx, indexing="ij"), dim=-1)
    cp = ctf_params[:, :, None, None]
    return _ctf_at_points(pts[None], n, pixel_size, cp[:, 0], cp[:, 1],
                          cp[:, 2], voltage_kv, cs_mm, w, cp[:, 3])


def _shift_correct(X, shifts, n):
    """Apply refined shifts: X * exp(-2*pi*i g.s / n) (centers particles)."""
    ky, kx = _wavenumbers(n, X.device)
    ph = (-2.0 * np.pi
          * (ky.reshape(1, n, 1) * shifts[:, 0, None, None]
             + kx.reshape(1, 1, -1) * shifts[:, 1, None, None])
          / n)
    return X * torch.complex(torch.cos(ph), torch.sin(ph))


def accumulate(
    stack,               # (B, n, n) particle images
    poses,               # (B, 5) (phi, theta, psi, sy, sx)
    ctf_params,          # (B, 4) (df1, df2, angast, phase)
    subset,              # (B,) int: 0 -> half 1, 1 -> half 2
    weights,             # (B,) per-particle weight
    n: int,
    pixel_size: float,
    voltage_kv: float = 300.0,
    cs_mm: float = 2.7,
    amplitude_contrast: float = 0.07,
    symmetry: str = "C1",
    pad: int = DEFAULT_PAD,
    prev: Accumulators | None = None,
    doses=None,
    gridding: str = "trilinear",
    iewald: int = 0,
    lblur=None,
    ref_fourier=None,
) -> Accumulators:
    """Insert a batch of particles (tensors on one device) into (possibly
    pre-existing) accumulators; every symmetry mate inserts once. `prev` is
    updated in place."""
    if doses is not None:
        raise NotImplementedError("dose weighting in accumulate is ported "
                                  "in a later PR")
    if lblur is not None:
        raise NotImplementedError("likelihood blurring (lblur) is ported in "
                                  "a later PR")
    if iewald or ref_fourier is not None:
        raise NotImplementedError("Ewald-sphere insertion (iewald != 0) is "
                                  "ported in a later PR")
    dev = stack.device
    X = _shift_correct(image_to_fourier(stack), poses[:, 3:5], n)
    ctfs = _ctf_grids(n, pixel_size, ctf_params, voltage_kv, cs_mm,
                      amplitude_contrast)
    R = euler_to_matrix(poses[:, 0], poses[:, 1], poses[:, 2])
    sym_mats = torch.as_tensor(apply_symmetry_matrices(symmetry), device=dev)

    pn = pad * n
    nxf = pn // 2 + 1
    if prev is None:
        prev = Accumulators(
            torch.zeros((pn, pn, nxf), dtype=torch.complex64, device=dev),
            torch.zeros((pn, pn, nxf), dtype=torch.float32, device=dev),
            torch.zeros((pn, pn, nxf), dtype=torch.complex64, device=dev),
            torch.zeros((pn, pn, nxf), dtype=torch.float32, device=dev))
    for k in range(sym_mats.shape[0]):
        parts = insert_slices_halves(X, ctfs, R @ sym_mats[k][None], subset,
                                     weights, n, pad=pad, gridding=gridding)
        for acc, part in zip(prev, parts):
            acc.add_(part)
    return prev


def merge_accumulators(accs) -> Accumulators:
    """Sum a list of shard accumulators (the merge3d 'dump file' merge)."""
    out = accs[0]
    for a in accs[1:]:
        out = Accumulators(*(x + y for x, y in zip(out, a)))
    return out


def finalize(acc: Accumulators, n: int, pad: int = DEFAULT_PAD,
             wiener: float = 0.5,
             gridding: str = "trilinear") -> Reconstruction:
    """Accumulators -> half maps, FSC curve, and the combined map filtered
    by the FSC's Cref weights."""
    half1 = reconstruct_from_accumulators(acc.num1, acc.den1, n, pad, wiener,
                                          gridding)
    half2 = reconstruct_from_accumulators(acc.num2, acc.den2, n, pad, wiener,
                                          gridding)
    freqs, curve = fsc_mod.fsc(half1, half2)
    combined = reconstruct_from_accumulators(
        acc.num1 + acc.num2, acc.den1 + acc.den2, n, pad, wiener, gridding)
    combined = fsc_mod.apply_fsc_filter(combined, torch.clamp(curve, 0.0, 1.0))
    return Reconstruction(volume=combined, half1=half1, half2=half2,
                          fsc=curve, freqs=freqs)


def reconstruct(
    stack, poses, ctf_params, pixel_size,
    subset=None, weights=None, symmetry: str = "C1",
    voltage_kv: float = 300.0, cs_mm: float = 2.7,
    amplitude_contrast: float = 0.07, wiener: float = 0.5,
    batch: int = 256, pad: int = DEFAULT_PAD, gridding: str = "trilinear",
    crop_to: int = None, iewald: int = 0,
    lblur_nrot: int = 0, lblur_range: float = 20.0,
    ref_volume=None, device="cpu",
) -> Reconstruction:
    """Reconstruction of a full particle stack on `device`, inserted in
    batches of at most `batch` particles. Inputs may be numpy arrays (each
    batch is uploaded) or tensors.

    crop_to: band-limited reconstruction grid — each batch is Fourier-
    cropped on the device, shifts and pixel size rescale, the pad factor
    grows to max(2, round(pad * n / n_rec)), and the returned maps live on
    the crop grid."""
    if iewald or ref_volume is not None:
        raise NotImplementedError("Ewald-sphere insertion (iewald != 0) is "
                                  "ported in a later PR")
    if lblur_nrot and lblur_nrot > 1:
        raise NotImplementedError("likelihood blurring (lblur) is ported in "
                                  "a later PR")
    dev = resolve_device(device)
    n = stack.shape[-1]
    B = stack.shape[0]
    subset = np.arange(B) % 2 if subset is None else subset
    weights = np.ones(B, dtype=np.float32) if weights is None else weights

    def on(x, dtype=torch.float32):
        x = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))
        return x.to(device=dev, dtype=dtype)

    n_rec, ratio = n, 1.0
    if crop_to is not None and crop_to < n:
        n_rec = int(crop_to)
        ratio = n_rec / float(n)
        # finer gridding on the crop grid: node spacing n_rec/(n*pad) of a
        # data wavenumber, round() not ceil() (pyp_tpu reconstruct.py:469)
        pad = max(2, int(round(pad * n / float(n_rec))))
    pixel_rec = pixel_size / ratio
    acc = None
    for i in range(0, B, batch):
        sl = slice(i, min(i + batch, B))
        xb = on(stack[sl])
        pb = on(poses[sl])
        if n_rec < n:
            xb = fourier_crop(xb, (n_rec, n_rec))
            pb = torch.cat([pb[:, :3], pb[:, 3:5] * ratio], dim=1)
        acc = accumulate(
            xb, pb, on(ctf_params[sl]), on(subset[sl], torch.int64),
            on(weights[sl]), n_rec, pixel_rec, voltage_kv, cs_mm,
            amplitude_contrast, symmetry, pad, prev=acc, gridding=gridding)
    return finalize(acc, n_rec, pad, wiener, gridding)


def save_accumulators(acc: Accumulators, path):
    """Persist shard accumulators as one npz with the JAX package's keys
    (num1, den1, num2, den2), so either package reads the other's file."""
    np.savez_compressed(
        path, **{k: getattr(acc, k).detach().cpu().numpy()
                 for k in Accumulators._fields})


def load_accumulators(path, device="cpu") -> Accumulators:
    dev = resolve_device(device)
    with np.load(path) as z:
        return Accumulators(*(torch.as_tensor(z[k]).to(dev)
                              for k in Accumulators._fields))
