"""Fourier-gridding insertion reconstruction — the torch port of
pyp_tpu/ops/reconstruct.py (the reconstruct3d/merge3d equivalents).

Particle spectra are shift-corrected, CTF-weighted and spread onto the
central slice of a 3D Fourier accumulator pair (numerator, CTF^2
denominator) per half set; shards accumulate independently and merge by
summation. The Wiener-regularized quotient with trilinear gridding
correction gives the half maps, their FSC, and the FSC-filtered combined
map.

`accumulate_matrices` inserts with explicit rotation matrices (the CSPT
path). Options of the insertion: dose weighting (`doses`), likelihood blurring
(`lblur`: one insertion per psi offset and symmetry mate) and Ewald-sphere
insertion (`iewald` ±1 curved, ±2 reference-based unmixing against the
current map).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pyp_tpu_torch import resolve_device
from pyp_tpu_torch.core import fsc as fsc_mod
from pyp_tpu_torch.core import ctf as ctf_model
from pyp_tpu_torch.core.fft import fourier_crop, fourier_crop_3d
from pyp_tpu_torch.core.geometry import apply_symmetry_matrices, euler_to_matrix
from pyp_tpu_torch.ops.fourier_slice import (
    DEFAULT_PAD,
    _wavenumbers,
    image_to_fourier,
    insert_slices_halves,
    reconstruct_from_accumulators,
    volume_to_fourier,
)
from pyp_tpu_torch.ops.refine3d import _ctf_at_points
from pyp_tpu_torch.utils.timer import span


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


def zero_accumulators(n: int, pad: int, device) -> Accumulators:
    """Empty accumulators of box `n` at pad factor `pad` on `device`."""
    pn = pad * n
    shape = (pn, pn, pn // 2 + 1)
    return Accumulators(
        torch.zeros(shape, dtype=torch.complex64, device=device),
        torch.zeros(shape, dtype=torch.float32, device=device),
        torch.zeros(shape, dtype=torch.complex64, device=device),
        torch.zeros(shape, dtype=torch.float32, device=device))


def _ctf_grids(n, pixel_size, ctf_params, voltage_kv, cs_mm, w):
    """Full-plane CTF images for a batch of particles: (B, n, n//2+1)."""
    ky, kx = _wavenumbers(n, ctf_params.device)
    pts = torch.stack(torch.meshgrid(ky, kx, indexing="ij"), dim=-1)
    cp = ctf_params[:, :, None, None]
    return _ctf_at_points(pts[None], n, pixel_size, cp[:, 0], cp[:, 1],
                          cp[:, 2], voltage_kv, cs_mm, w, cp[:, 3])


def _chi_grids(n, pixel_size, ctf_params, voltage_kv, cs_mm, w):
    """Total aberration phase grids chi_tot (B, n, n//2+1) such that
    CTF = -sin(chi_tot): the branch phase of the reference-based Ewald
    insertion (insert_slices_halves' chi argument)."""
    ky, kx = _wavenumbers(n, ctf_params.device)
    gy = ky[:, None] / (n * pixel_size)
    gx = kx[None, :] / (n * pixel_size)
    g = torch.sqrt(gy * gy + gx * gx)
    azim = torch.atan2(gy, gx)
    amp = float(np.arctan2(w, np.sqrt(max(1.0 - w * w, 0.0))))
    cp = ctf_params[:, :, None, None]
    df = ctf_model.defocus_at_azimuth(cp[:, 0], cp[:, 1], cp[:, 2], azim)
    return ctf_model.chi(g, df, voltage_kv, cs_mm, cp[:, 3]) + amp


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
    updated in place.

    doses (B,): cumulative exposures (e-/Å²) apply the Grant-Grigorieff
    damage envelope to each particle's CTF weight.

    iewald: ±1 curved insertion at curvature sign * lambda / (2 n pixel)
    (handedness-invariant); ±2 with `ref_fourier` (the padded spectrum of
    the current map) the reference-based unmixing, whose sign is the
    handedness, its amplitude fitted to each particle
    (insert_slices_halves); ±2 without a reference degrades to ±1.

    lblur: an (offsets_deg, rel_weights) bank (lblur_bank): each particle
    inserts at every psi offset around its refined in-plane angle with the
    relative weight, once per symmetry mate."""
    dev = stack.device
    X = _shift_correct(image_to_fourier(stack), poses[:, 3:5], n)
    ctfs = _ctf_grids(n, pixel_size, ctf_params, voltage_kv, cs_mm,
                      amplitude_contrast)
    if doses is not None:
        ky = np.fft.fftfreq(n, d=pixel_size).reshape(n, 1)
        kx = np.fft.rfftfreq(n, d=pixel_size).reshape(1, -1)
        g = torch.as_tensor(np.sqrt(ky * ky + kx * kx).astype(np.float32),
                            device=dev)
        doses = torch.as_tensor(doses, dtype=torch.float32, device=dev)
        ctfs = ctfs * ctf_model.dose_weight(g[None], doses[:, None, None])
    sym_mats = torch.as_tensor(apply_symmetry_matrices(symmetry), device=dev)

    ewald_c = 0.0
    if iewald:
        ewald_c = (float(np.sign(iewald)) * ctf_model.wavelength_host(voltage_kv)
                   / (2.0 * n * pixel_size))
    chi = None
    if abs(iewald) >= 2 and ref_fourier is not None and ewald_c:
        chi = _chi_grids(n, pixel_size, ctf_params, voltage_kv, cs_mm,
                         amplitude_contrast)
    if lblur is not None:
        blur_terms = [(euler_to_matrix(poses[:, 0], poses[:, 1],
                                       poses[:, 2] + float(off)),
                       weights * float(w))
                      for off, w in zip(*lblur)]
    else:
        blur_terms = [(euler_to_matrix(poses[:, 0], poses[:, 1],
                                       poses[:, 2]), weights)]

    if prev is None:
        prev = zero_accumulators(n, pad, dev)
    for R, wb in blur_terms:
        for k in range(sym_mats.shape[0]):
            parts = insert_slices_halves(
                X, ctfs, R @ sym_mats[k][None], subset, wb, n, pad=pad,
                gridding=gridding, ewald_c=ewald_c,
                ref_fourier=ref_fourier if chi is not None else None,
                chi=chi)
            for acc, part in zip(prev, parts):
                acc.add_(part)
    return prev


@span("reconstruct.accumulate_matrices")
def accumulate_matrices(
    windows,             # (B, n, n) particle projections (e.g. CSP windows)
    rotations,           # (B, 3, 3) full projection rotations (R_eff)
    shifts,              # (B, 2) residual shifts to apply (pixels)
    defoci,              # (B,) mean defocus per projection (Å)
    subset,              # (B,) 0/1 half assignment
    weights,             # (B,) weights (exposure * occupancy)
    n: int,
    pixel_size: float,
    voltage_kv: float = 300.0,
    cs_mm: float = 2.7,
    amplitude_contrast: float = 0.07,
    pad: int = DEFAULT_PAD,
    prev: Accumulators | None = None,
    iewald: int = 0,
    ref_fourier=None,
) -> Accumulators:
    """Insertion with explicit rotation matrices — the CSPT path: each
    (tilt, particle) projection window contributes a slice at pose
    R_eff = R_tilt @ M_particle. Tensors on one device; `prev` is updated
    in place. iewald: Ewald-sphere correction (see `accumulate`; magnitude
    2 + ref_fourier = reference-based unmixing)."""
    dev = windows.device
    X = _shift_correct(image_to_fourier(windows), shifts, n)
    z = torch.zeros_like(defoci)
    cp = torch.stack([defoci, defoci, z, z], 1)
    ctfs = _ctf_grids(n, pixel_size, cp, voltage_kv, cs_mm,
                      amplitude_contrast)
    if prev is None:
        prev = zero_accumulators(n, pad, dev)
    ewald_c = 0.0
    if iewald:
        ewald_c = (float(np.sign(iewald)) * ctf_model.wavelength_host(voltage_kv)
                   / (2.0 * n * pixel_size))
    chi = None
    if abs(iewald) >= 2 and ref_fourier is not None and ewald_c:
        chi = _chi_grids(n, pixel_size, cp, voltage_kv, cs_mm,
                         amplitude_contrast)
    parts = insert_slices_halves(
        X, ctfs, rotations, subset, weights, n, pad=pad, ewald_c=ewald_c,
        ref_fourier=ref_fourier if chi is not None else None, chi=chi)
    for acc, part in zip(prev, parts):
        acc.add_(part)
    return prev


def lblur_bank(lblur_nrot: int, lblur_range: float = 20.0):
    """Likelihood-blurring (offsets, weights) bank, or None when disabled:
    lblur_nrot psi offsets across lblur_range degrees centred on the
    refined in-plane angle, Gaussian weights with FWHM half the window,
    normalized to unit mass."""
    if not lblur_nrot or lblur_nrot <= 1:
        return None
    offs = np.linspace(-lblur_range / 2.0, lblur_range / 2.0,
                       int(lblur_nrot))
    sigma = max((lblur_range / 2.0) / 2.355, 1e-3)
    rw = np.exp(-0.5 * (offs / sigma) ** 2)
    rw = rw / rw.sum()
    return tuple(float(o) for o in offs), tuple(float(w) for w in rw)


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
    ref_volume=None, device="cuda",
) -> Reconstruction:
    """Reconstruction of a full particle stack on `device`, inserted in
    batches of at most `batch` particles. Inputs may be numpy arrays (each
    batch is uploaded) or tensors.

    crop_to: band-limited reconstruction grid — each batch is Fourier-
    cropped on the device, shifts and pixel size rescale, the pad factor
    grows to max(2, round(pad * n / n_rec)), and the returned maps live on
    the crop grid.

    iewald, ref_volume: Ewald-sphere insertion (see `accumulate`); at ±2
    the reference's padded spectrum (pad 2, Fourier-cropped with the stack
    under crop_to) is built once and shared by every batch. lblur_nrot > 1
    with lblur_range: likelihood blurring (lblur_bank)."""
    acc, n_rec, pad = accumulate_stack(
        stack, poses, ctf_params, pixel_size, subset=subset, weights=weights,
        symmetry=symmetry, voltage_kv=voltage_kv, cs_mm=cs_mm,
        amplitude_contrast=amplitude_contrast, batch=batch, pad=pad,
        gridding=gridding, crop_to=crop_to, iewald=iewald,
        lblur_nrot=lblur_nrot, lblur_range=lblur_range,
        ref_volume=ref_volume, device=device)
    return finalize(acc, n_rec, pad, wiener, gridding)


def accumulate_stack(
    stack, poses, ctf_params, pixel_size,
    subset=None, weights=None, symmetry: str = "C1",
    voltage_kv: float = 300.0, cs_mm: float = 2.7,
    amplitude_contrast: float = 0.07, batch: int = 256,
    pad: int = DEFAULT_PAD, gridding: str = "trilinear",
    crop_to: int = None, iewald: int = 0,
    lblur_nrot: int = 0, lblur_range: float = 20.0,
    ref_volume=None, rows: slice | None = None, device="cuda",
):
    """The insertion half of `reconstruct` (same arguments) for the rows
    `rows` of the stack (all by default; an empty range gives empty
    accumulators). Returns (Accumulators, n_rec, pad): the grid and pad
    factor `finalize` takes."""
    dev = resolve_device(device)
    n = stack.shape[-1]
    B = stack.shape[0]
    subset = np.arange(B) % 2 if subset is None else subset
    weights = np.ones(B, dtype=np.float32) if weights is None else weights
    lo, hi, _ = (rows or slice(0, B)).indices(B)

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
    lblur = lblur_bank(lblur_nrot, lblur_range)
    ref_fourier = None
    if abs(iewald) >= 2 and ref_volume is not None:
        rv = on(ref_volume)
        if n_rec < n:
            rv = fourier_crop_3d(rv, (n_rec, n_rec, n_rec))
        ref_fourier = volume_to_fourier(rv, pad=2)
    acc = zero_accumulators(n_rec, pad, dev)
    for i in range(lo, hi, batch):
        sl = slice(i, min(i + batch, hi))
        xb = on(stack[sl])
        pb = on(poses[sl])
        if n_rec < n:
            xb = fourier_crop(xb, (n_rec, n_rec))
            pb = torch.cat([pb[:, :3], pb[:, 3:5] * ratio], dim=1)
        acc = accumulate(
            xb, pb, on(ctf_params[sl]), on(subset[sl], torch.int64),
            on(weights[sl]), n_rec, pixel_rec, voltage_kv, cs_mm,
            amplitude_contrast, symmetry, pad, prev=acc, gridding=gridding,
            iewald=iewald, lblur=lblur, ref_fourier=ref_fourier)
    return acc, n_rec, pad


def save_accumulators(acc: Accumulators, path):
    """Persist shard accumulators as one npz with the JAX package's keys
    (num1, den1, num2, den2), so either package reads the other's file.
    Stored uncompressed: the accumulators are noise-like floats, which
    zlib shrinks by a few percent at many times the write time (a box-256
    CSP dump holds 1.6 GB)."""
    np.savez(
        path, **{k: getattr(acc, k).detach().cpu().numpy()
                 for k in Accumulators._fields})


def load_accumulators(path, device="cuda") -> Accumulators:
    """Accumulators saved by either package, on `device`."""
    dev = resolve_device(device)
    with np.load(path) as z:
        return Accumulators(*(torch.as_tensor(z[k]).to(dev)
                              for k in Accumulators._fields))
