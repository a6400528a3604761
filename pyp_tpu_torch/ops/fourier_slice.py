"""Central-slice Fourier operators: projection (slice gather) and insertion
(slice scatter) with Hermitian-symmetric rfft layouts — the torch port of
pyp_tpu/ops/fourier_slice.py.

Conventions (the same as the JAX package's):
  * volumes/images are "centered": the phase origin sits at the center
    sample (index n//2), by multiplying the raw FFT with the frequency
    checkerboard (-1)^(sum of indices);
  * volumes (and, in the search path, particle images) are zero-padded by
    `pad` before the FFT; gather/scatter coordinates are given in unpadded
    image wavenumber units and scaled by `pad` internally;
  * poses are ZYZ Euler angles: R = Rz(psi)Ry(theta)Rz(phi) maps volume
    coords to image coords; F_image(g) = F_vol(R^T [gx, gy, 0]);
  * shifts (sy, sx) in pixels translate image content toward +y/+x.

Gathers are differentiable in their coordinates (through the trilinear /
bilinear weights); the spectrum itself needs no gradient.
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_PAD = 2


def _freq_checkerboard_2d(n: int, device="cpu"):
    i = (torch.arange(n, device=device)[:, None]
         + torch.arange(n // 2 + 1, device=device)[None, :]) % 2
    return 1.0 - 2.0 * i.to(torch.float32)


def _freq_checkerboard_3d(n: int, device="cpu"):
    a = torch.arange(n, device=device)
    s = (a.reshape(n, 1, 1) + a.reshape(1, n, 1)
         + torch.arange(n // 2 + 1, device=device).reshape(1, 1, -1)) % 2
    return 1.0 - 2.0 * s.to(torch.float32)


def _wavenumbers(n: int, device):
    """(ky, kx) integer wavenumbers of the rfft half-plane as float32."""
    ky = torch.as_tensor((np.fft.fftfreq(n) * n).astype(np.float32),
                         device=device)
    kx = torch.arange(n // 2 + 1, dtype=torch.float32, device=device)
    return ky, kx


def pad_image(imgs, pad: int):
    """Zero-pad (..., n, n) images to (..., pad*n, pad*n) keeping the object
    centered (center n//2 -> center pad*n//2)."""
    if pad == 1:
        return imgs
    n = imgs.shape[-1]
    off = (pad * n) // 2 - n // 2
    hi = pad * n - n - off
    return torch.nn.functional.pad(imgs, (off, hi, off, hi))


def pad_volume(vol, pad: int):
    if pad == 1:
        return vol
    n = vol.shape[-1]
    off = (pad * n) // 2 - n // 2
    hi = pad * n - n - off
    return torch.nn.functional.pad(vol, (off, hi, off, hi, off, hi))


def image_to_fourier(imgs, pad: int = 1):
    """Centered 2D spectra (..., pad*n, pad*n//2+1); optionally oversampled
    by zero padding. Any real input dtype is upcast to float32."""
    x = pad_image(imgs.to(torch.float32), pad)
    n = x.shape[-1]
    return torch.fft.rfft2(x) * _freq_checkerboard_2d(n, x.device)


def fourier_to_image(F, n: int):
    """Inverse of image_to_fourier for pad=1 spectra."""
    return torch.fft.irfft2(F * _freq_checkerboard_2d(n, F.device), s=(n, n))


def volume_to_fourier(vol, pad: int = DEFAULT_PAD):
    """Centered, `pad`-times oversampled 3D spectrum of a cubic volume."""
    v = pad_volume(vol.to(torch.float32), pad)
    n = v.shape[-1]
    return (torch.fft.rfftn(v, dim=(-3, -2, -1))
            * _freq_checkerboard_3d(n, v.device))


def fourier_to_volume(F, n: int, pad: int = 1):
    """Inverse: padded spectrum -> cropped central (n, n, n) volume. One
    axis at a time, cropping that axis to n before the next: the centered
    n-window of ifft(F * (-1)^k) lives at wrapped corner rows of the raw
    transform, so no checkerboard product is needed."""
    pn = n * pad
    idx = (torch.arange(n, device=F.device) + (pn - n // 2)) % pn
    v = torch.fft.ifft(F, n=pn, dim=-3).index_select(-3, idx)
    v = torch.fft.ifft(v, n=pn, dim=-2).index_select(-2, idx)
    v = torch.fft.irfft(v, n=pn, dim=-1)
    return v.index_select(-1, idx)


# ---------------------------------------------------------------------------
# Hermitian-aware gathers
# ---------------------------------------------------------------------------

def gather_3d_hermitian(Fvol, q, scale: float = 1.0):
    """Trilinear interpolation of a 3D rfft-layout spectrum (n, n, nxf) at
    continuous wavenumber coordinates q (..., 3) ordered (qz, qy, qx).
    `scale` multiplies coordinates first (pad-factor oversampling). Friedel
    mates are used for qx < 0; points beyond the Nyquist sphere return 0."""
    n = Fvol.shape[0]
    nxf = Fvol.shape[2]
    flat_F = Fvol.reshape(-1)
    q = q * scale
    flip = q[..., 2] < 0
    qs = torch.where(flip[..., None], -q, q)
    q0f = torch.floor(qs)
    frac = qs - q0f
    q0 = q0f.to(torch.int64)

    out = None
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                w = ((frac[..., 0] if dz else 1 - frac[..., 0])
                     * (frac[..., 1] if dy else 1 - frac[..., 1])
                     * (frac[..., 2] if dx else 1 - frac[..., 2]))
                kz = q0[..., 0] + dz
                ky = q0[..., 1] + dy
                kx = q0[..., 2] + dx
                neg = kx < 0
                kzz = torch.where(neg, -kz, kz) % n     # floor-mod
                kyy = torch.where(neg, -ky, ky) % n
                kxx = torch.where(neg, -kx, kx)
                valid = kxx <= nxf - 1
                kxx = torch.clamp(kxx, 0, nxf - 1)
                vals = flat_F[(kzz * n + kyy) * nxf + kxx]
                vals = torch.where(neg, vals.conj(), vals)
                term = torch.where(valid, w, torch.zeros_like(w)) * vals
                out = term if out is None else out + term
    out = torch.where(flip, out.conj(), out)
    r2 = torch.sum(q * q, dim=-1)
    return torch.where(r2 <= (n // 2) ** 2, out, torch.zeros_like(out))


def gather_2d_hermitian(Fimg, p, scale: float = 1.0):
    """Bilinear interpolation of 2D rfft-layout spectra Fimg (*batch, n,
    nxf) at continuous wavenumber coords p (*points, 2) ordered (ky, kx).
    Friedel-aware. Returns (*batch, *points): every spectrum is sampled at
    every point (the JAX function's single-image form when `batch` is
    empty, its vmap over images otherwise)."""
    n = Fimg.shape[-2]
    nxf = Fimg.shape[-1]
    batch = Fimg.shape[:-2]
    flat_F = Fimg.reshape(batch + (n * nxf,))
    pshape = p.shape[:-1]
    p = p * scale
    flip = p[..., 1] < 0
    ps = torch.where(flip[..., None], -p, p)
    p0f = torch.floor(ps)
    frac = ps - p0f
    p0 = p0f.to(torch.int64)

    out = None
    for dy in (0, 1):
        for dx in (0, 1):
            w = ((frac[..., 0] if dy else 1 - frac[..., 0])
                 * (frac[..., 1] if dx else 1 - frac[..., 1]))
            ky = p0[..., 0] + dy
            kx = p0[..., 1] + dx
            neg = kx < 0
            kyy = torch.where(neg, -ky, ky) % n
            kxx = torch.where(neg, -kx, kx)
            valid = kxx <= nxf - 1
            kxx = torch.clamp(kxx, 0, nxf - 1)
            vals = flat_F[..., (kyy * nxf + kxx).reshape(-1)]
            vals = vals.reshape(batch + pshape)
            vals = torch.where(neg, vals.conj(), vals)
            term = torch.where(valid, w, torch.zeros_like(w)) * vals
            out = term if out is None else out + term
    return torch.where(flip, out.conj(), out)


# ---------------------------------------------------------------------------
# projection / insertion
# ---------------------------------------------------------------------------

def slice_coords(R, n: int):
    """3D wavenumber coords of the central slice for rotation(s) R
    (..., 3, 3), in unpadded image wavenumber units: (..., n, n//2+1, 3)
    ordered (qz, qy, qx)."""
    ky, kx = _wavenumbers(n, R.device)
    gy = ky[:, None]
    gx = kx[None, :]
    ex = R[..., 0, :]  # image x axis in volume coords
    ey = R[..., 1, :]
    q_xyz = (gx[..., None] * ex[..., None, None, :]
             + gy[..., None] * ey[..., None, None, :])
    return q_xyz.flip(-1)


def project(Fvol, R, n: int):
    """Central slice(s) of a padded volume spectrum: (..., n, n//2+1)
    spectra of projections at the unpadded image resolution."""
    pad = Fvol.shape[0] // n
    return gather_3d_hermitian(Fvol, slice_coords(R, n), scale=float(pad))


def _corner_lists(qs, vals, c2, q0, frac, in_sphere, pn, nxf):
    """Flattened (index, Re, Im, CTF^2) lists over the 8 trilinear gridding
    corners."""
    idx_all, wv_re, wv_im, wc2 = [], [], [], []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                w = ((frac[..., 0] if dz else 1 - frac[..., 0])
                     * (frac[..., 1] if dy else 1 - frac[..., 1])
                     * (frac[..., 2] if dx else 1 - frac[..., 2]))
                kz = q0[..., 0] + dz
                ky = q0[..., 1] + dy
                kx = q0[..., 2] + dx
                neg = kx < 0
                kzz = torch.where(neg, -kz, kz) % pn
                kyy = torch.where(neg, -ky, ky) % pn
                kxx = torch.where(neg, -kx, kx)
                valid = (kxx <= nxf - 1) & in_sphere
                kxx = torch.clamp(kxx, 0, nxf - 1)
                w = torch.where(valid, w, torch.zeros_like(w))
                v = torch.where(neg, vals.conj(), vals)
                idx_all.append(((kzz * pn + kyy) * nxf + kxx).reshape(-1))
                wv_re.append((w * v.real).reshape(-1))
                wv_im.append((w * v.imag).reshape(-1))
                wc2.append((w * c2).reshape(-1))
    return (torch.cat(idx_all), torch.cat(wv_re), torch.cat(wv_im),
            torch.cat(wc2))


def insert_slices_halves(F_parts, ctfs, R, subset, weights, n: int,
                         pad: int = DEFAULT_PAD, gridding: str = "trilinear",
                         ewald_c: float = 0.0, ref_fourier=None, chi=None):
    """CTF-weighted trilinear gridding insertion of particle spectra into
    the num/den accumulators of both half sets in one scatter pass: the half
    id offsets the flat index into a doubled float32 buffer. F_parts, ctfs
    (B, n, n//2+1); R (B, 3, 3); subset (B,) 0/1; weights (B,). Returns
    (num1, den1, num2, den2) on the (pn, pn, pn//2+1) grid, pn = pad*n.

    The scatter is `index_add_`, which uses atomics on CUDA: the order of
    the sums varies from run to run."""
    if ewald_c or ref_fourier is not None or chi is not None:
        raise NotImplementedError(
            "Ewald-sphere insertion (IEWALD != 0) is ported in a later PR")
    pn = pad * n
    nxf = pn // 2 + 1
    q = slice_coords(R, n) * pad
    w3 = weights.to(torch.float32)[:, None, None]
    vals = F_parts * ctfs * w3
    c2 = ctfs * ctfs * w3
    flip = q[..., 2] < 0
    qs = torch.where(flip[..., None], -q, q)
    vals = torch.where(flip, vals.conj(), vals)
    q0f = torch.floor(qs)
    frac = qs - q0f
    q0 = q0f.to(torch.int64)
    in_sphere = torch.sum(q * q, dim=-1) <= (pn // 2) ** 2

    idx, wre, wim, wc2 = _corner_lists(qs, vals, c2, q0, frac, in_sphere,
                                       pn, nxf)
    size = pn * pn * nxf
    B = vals.shape[0]
    per = idx.shape[0] // (8 * B)
    half = torch.clamp(subset.to(torch.int64), 0, 1)
    idx = idx + half.repeat_interleave(per).repeat(8) * size
    kw = dict(dtype=torch.float32, device=F_parts.device)
    num_re = torch.zeros(2 * size, **kw).index_add_(0, idx, wre)
    num_im = torch.zeros(2 * size, **kw).index_add_(0, idx, wim)
    den = torch.zeros(2 * size, **kw).index_add_(0, idx, wc2)
    num = torch.complex(num_re, num_im).reshape(2, pn, pn, nxf)
    den = den.reshape(2, pn, pn, nxf)
    return num[0], den[0], num[1], den[1]


def gridding_correction(n: int, pad: int = DEFAULT_PAD, power: int = 2,
                        device="cpu"):
    """Real-space correction over the cropped n-box for the gridding kernel
    on the padded grid: sinc^power((x - c)/pn) per axis, floored at 1e-3."""
    pn = n * pad
    ax = (torch.arange(n, dtype=torch.float32, device=device) - n // 2) / pn
    s = torch.sinc(ax) ** power
    c = s[:, None, None] * s[None, :, None] * s[None, None, :]
    return torch.clamp(c, min=1e-3)


def reconstruct_from_accumulators(num, den, n: int, pad: int = DEFAULT_PAD,
                                  wiener: float = 1.0,
                                  gridding: str = "trilinear"):
    """num/den -> real-space n-box map: Wiener-regularized division, the
    inverse FFT that crops between axis passes, the pad^3 amplitude rescale
    and the kernel-matched gridding correction."""
    vol = fourier_to_volume(num / (den + wiener), n, pad) * (pad ** 3)
    return vol / gridding_correction(
        n, pad, power=1 if gridding == "nearest" else 2, device=num.device)
