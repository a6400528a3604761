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

from pyp_tpu_torch.utils.timer import span

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
    # contiguous: the card's rfftn returns another stride order, which
    # every flat gather of the spectrum would otherwise copy
    return (torch.fft.rfftn(v, dim=(-3, -2, -1))
            * _freq_checkerboard_3d(n, v.device)).contiguous()


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


def slice_points(R, pts):
    """3D wavenumber coords of the central slice for rotation(s) R
    (..., 3, 3) at 2D points pts (G, 2) ordered (ky, kx): q = kx R[0] + ky
    R[1], as (..., G, 3) ordered (qz, qy, qx)."""
    return (pts[:, 1, None] * R[..., None, 0, :]
            + pts[:, 0, None] * R[..., None, 1, :]).flip(-1)


def slice_at_points(R, pts, Fvol, scale: float):
    """Values (..., G) of a padded volume spectrum Fvol on the central
    slice(s) of R (..., 3, 3) at the points pts (G, 2) (ky, kx), the
    coordinates times `scale` (the padding; gather_3d_hermitian's rules)."""
    return gather_3d_hermitian(Fvol, slice_points(R, pts), scale=scale)


def project(Fvol, R, n: int):
    """Central slice(s) of a padded volume spectrum: (..., n, n//2+1)
    spectra of projections at the unpadded image resolution."""
    pad = Fvol.shape[0] // n
    return gather_3d_hermitian(Fvol, slice_coords(R, n), scale=float(pad))


def project_ewald(Fvol, R, n: int, ewald_c: float):
    """Curved-sphere projection spectra: the physical image on the Ewald
    sphere mixes both branches, X(g) = (F(s+) + F*(s-)) / 2 with
    s± = ±g.e + c g² ez — hermitian by construction, and equal to
    `project` at ewald_c = 0."""
    pad = Fvol.shape[0] // n
    q = slice_coords(R, n)
    curve = _ewald_curve(R, n, ewald_c)
    Fp = gather_3d_hermitian(Fvol, q + curve, scale=float(pad))
    Fm = gather_3d_hermitian(Fvol, -q + curve, scale=float(pad))
    return 0.5 * (Fp + Fm.conj())


def project_real(vol, phi, theta, psi, pad: int = DEFAULT_PAD):
    """Real-space projection images (B, n, n) of a volume (tensor) for
    Euler angle arrays, on the volume's device."""
    from pyp_tpu_torch.core.geometry import euler_to_matrix

    n = vol.shape[-1]
    dev = vol.device

    def ang(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)

    R = euler_to_matrix(ang(phi), ang(theta), ang(psi))
    return fourier_to_image(project(volume_to_fourier(vol, pad), R, n), n)


def _ewald_curve(R, n: int, ewald_c: float):
    """Sphere offsets c |g|² ez (B, n, n//2+1, 3) in (z, y, x) order, in
    unpadded wavenumber units: ez is the beam axis in volume coords."""
    ky, kx = _wavenumbers(n, R.device)
    g2 = ky[:, None] ** 2 + kx[None, :] ** 2
    ez = R[..., 2, :].flip(-1)
    return ewald_c * g2[None, :, :, None] * ez[:, None, None, :]


@span("insert.scatter")
def _scatter(q, vals, c2, pn: int, nxf: int, n_sets: int, set_id):
    """Trilinear scatter of (vals, c2) at padded coords q into n_sets
    stacked (pn, pn, nxf) accumulator pairs; set_id (B,) picks each
    slice's set (None: all in set 0). Returns (num (n_sets, ...) complex,
    den (n_sets, ...) real). On the card one kernel
    (`kernels.insert_scatter`), on the CPU its plain version."""
    from pyp_tpu_torch.ops import kernels

    return kernels.insert_scatter(q, vals, c2, set_id, pn, nxf, n_sets)


def insert_slices(F_parts, ctfs, R, n: int, pad: int = DEFAULT_PAD,
                  weights=None):
    """CTF-weighted trilinear gridding insertion of particle spectra into
    one oversampled accumulator pair: num += w CTF F, den += w CTF^2 at
    pad*q. F_parts, ctfs (B, n, n//2+1); R (B, 3, 3). Returns (num, den)
    on the (pn, pn, pn//2+1) grid, pn = pad*n."""
    pn = pad * n
    vals = F_parts * ctfs
    c2 = ctfs * ctfs
    if weights is not None:
        w3 = weights.to(torch.float32)[:, None, None]
        vals, c2 = vals * w3, c2 * w3
    num, den = _scatter(slice_coords(R, n) * pad, vals, c2, pn,
                        pn // 2 + 1, 1, None)
    return num[0], den[0]


def ref_amplitude(pred, F_parts):
    """Least-squares amplitude (B,) of each predicted image `pred` against
    its particle's spectrum F_parts (both (B, n, n//2+1) complex), floored
    at 0."""
    num = (pred.conj() * F_parts).real.sum((-2, -1))
    den = (pred.real ** 2 + pred.imag ** 2).sum((-2, -1))
    return torch.clamp(num / torch.clamp(den, min=1e-30), min=0.0)


def insert_slices_halves(F_parts, ctfs, R, subset, weights, n: int,
                         pad: int = DEFAULT_PAD, gridding: str = "trilinear",
                         ewald_c: float = 0.0, ref_fourier=None, chi=None):
    """CTF-weighted trilinear gridding insertion of particle spectra into
    the num/den accumulators of both half sets in one scatter pass: the half
    id offsets the flat index into a doubled float32 buffer. F_parts, ctfs
    (B, n, n//2+1); R (B, 3, 3); subset (B,) 0/1; weights (B,). Returns
    (num1, den1, num2, den2) on the (pn, pn, pn//2+1) grid, pn = pad*n.

    ewald_c: Ewald-sphere curvature in index units (lambda / (2 n pixel),
    signed by handedness; IEWALD ±1). Each sample lands on the sphere,
    offset c |g|² along the beam axis; the curvature is even in g, so both
    sides insert explicitly (X(g) at g.e + c g² ez, X*(g) at
    -g.e + c g² ez): 2B slices, each carrying its particle's half id.

    ref_fourier + chi (with ewald_c): the reference-based unmixing of
    IEWALD ±2. With ctf+ = (i/2) e^{i chi}, the measured spectrum is
    X(g) = ctf+ F(s+) + conj(ctf+) F*(s-); the reference (sampled at its
    own pad, ref_fourier.shape[0] // n) predicts the opposite branch,
    which is subtracted, and the rest is matched-filtered by conj(ctf+)
    with den += |ctf+|² w = w/4. Any envelope folded into `ctfs` is not
    applied on that path. The reference is first scaled, per particle, by
    `ref_amplitude`, so a reference on another scale than the particles
    (a normalized stack, a band-limited map, a map from another source)
    predicts the opposite branch at the data's scale; the JAX package
    inserts it unscaled, which is the same insertion where that amplitude
    is 1.

    The scatter uses atomics on CUDA: the order of the sums varies from
    run to run."""
    pn = pad * n
    q_u = slice_coords(R, n)
    w3 = weights.to(torch.float32)[:, None, None]
    vals = F_parts * ctfs * w3
    c2 = ctfs * ctfs * w3
    q = q_u * pad
    subset = subset.to(torch.int64)
    if ewald_c:
        curve_u = _ewald_curve(R, n, ewald_c)
        if ref_fourier is not None and chi is not None:
            pad_ref = ref_fourier.shape[0] // n
            Rp = gather_3d_hermitian(ref_fourier, q_u + curve_u,
                                     scale=float(pad_ref))
            Rm = gather_3d_hermitian(ref_fourier, -q_u + curve_u,
                                     scale=float(pad_ref))
            ctfp_c = (0.5j * torch.polar(torch.ones_like(chi), chi)).conj()
            a = ref_amplitude(ctfp_c.conj() * Rp + ctfp_c * Rm.conj(),
                              F_parts)[:, None, None]
            Rp, Rm = Rp * a, Rm * a
            Yp = F_parts - ctfp_c * Rm.conj()      # remove the F*(s-) term
            Ym = F_parts.conj() - ctfp_c * Rp.conj()  # remove the F*(s+) term
            vals = torch.cat([ctfp_c * Yp * w3, ctfp_c * Ym * w3])
            c2b = 0.25 * w3 * torch.ones_like(chi)
            c2 = torch.cat([c2b, c2b])
        else:
            vals = torch.cat([vals, vals.conj()])
            c2 = torch.cat([c2, c2])
        curve = curve_u * pad
        q = torch.cat([q + curve, -q + curve])
        subset = torch.cat([subset, subset])
    num, den = _scatter(q, vals, c2, pn, pn // 2 + 1, 2,
                        torch.clamp(subset, 0, 1))
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
