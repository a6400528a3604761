"""Plain Fourier-space geometry of cryo-EM, written for the benchmark alone.

Conventions (the published ones of FREALIGN / cisTEM, which the system under
test follows too):
  * images and volumes are centred: the phase origin is the centre sample
    (index n//2), so a spectrum is the raw FFT times (-1)^(sum of indices);
  * a pose R(phi, theta, psi) = Rz(psi) Ry(theta) Rz(phi) maps volume
    coordinates to image coordinates, and the image spectrum at (gy, gx)
    is the volume spectrum at gx R[0] + gy R[1];
  * wavenumbers are integers on the unpadded grid; a padded spectrum is
    sampled at `pad` times the coordinate;
  * a shift s (pixels, (y, x)) moves image content toward +s when the
    spectrum is multiplied by exp(-2 pi i g.s / n).

Every function works in the dtype of its inputs (float32 or float64 and the
matching complex type), on their device.
"""

from __future__ import annotations

import math

import torch


def checkerboard(shape, device, dtype=torch.float32):
    """(-1)^(sum of indices) over an rfft layout of the given full shape."""
    axes = [torch.arange(s, device=device) for s in shape[:-1]]
    axes.append(torch.arange(shape[-1] // 2 + 1, device=device))
    total = 0
    for i, a in enumerate(axes):
        view = [1] * len(axes)
        view[i] = -1
        total = total + a.reshape(view)
    return (1 - 2 * (total % 2)).to(dtype)


def wavenumbers(n, device, dtype=torch.float32):
    """(ky, kx): signed integer wavenumbers of the rfft half-plane."""
    ky = torch.fft.fftfreq(n, d=1.0 / n, device=device, dtype=dtype).round()
    kx = torch.arange(n // 2 + 1, device=device, dtype=dtype)
    return ky, kx


def pad_centered(x, pad, dims):
    """Zero-pad the last `dims` axes from n to pad*n, keeping the centre."""
    if pad == 1:
        return x
    n = x.shape[-1]
    lo = (pad * n) // 2 - n // 2
    hi = pad * n - n - lo
    return torch.nn.functional.pad(x, (lo, hi) * dims)


def image_to_fourier(imgs):
    """Centred rfft2 of real images (..., n, n)."""
    n = imgs.shape[-1]
    return torch.fft.rfft2(imgs) * checkerboard((n, n), imgs.device, imgs.dtype)


def fourier_to_image(F, n):
    """Inverse of image_to_fourier."""
    real = F.real.dtype
    return torch.fft.irfft2(F * checkerboard((n, n), F.device, real), s=(n, n))


def volume_to_fourier(vol, pad=2):
    """Centred, pad-times oversampled rfftn of a cubic volume."""
    v = pad_centered(vol, pad, 3)
    pn = v.shape[-1]
    return torch.fft.rfftn(v, dim=(-3, -2, -1)) * checkerboard(
        (pn, pn, pn), v.device, v.dtype)


def rot(angle_deg, axis):
    a = torch.deg2rad(angle_deg)
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    if axis == "z":
        rows = [[c, -s, z], [s, c, z], [z, z, o]]
    else:
        rows = [[c, z, s], [z, o, z], [-s, z, c]]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def euler_to_matrix(phi, theta, psi):
    """ZYZ: Rz(psi) Ry(theta) Rz(phi), angles in degrees."""
    phi, theta, psi = torch.broadcast_tensors(phi, theta, psi)
    return rot(psi, "z") @ rot(theta, "y") @ rot(phi, "z")


def gather_3d(Fvol, q, scale=1.0):
    """Trilinear value of an rfft-layout volume spectrum (m, m, m//2+1) at
    wavenumbers q (..., 3) ordered (z, y, x), times `scale`. Points with
    x < 0 read the Friedel mate; points beyond radius m/2 read 0."""
    m, nxf = Fvol.shape[0], Fvol.shape[2]
    flat = Fvol.reshape(-1)
    q = q * scale
    flip = q[..., 2] < 0
    qs = torch.where(flip[..., None], -q, q)
    base = torch.floor(qs)
    frac = qs - base
    base = base.to(torch.int64)
    out = torch.zeros(q.shape[:-1], dtype=Fvol.dtype, device=Fvol.device)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                w = ((frac[..., 0] if dz else 1 - frac[..., 0])
                     * (frac[..., 1] if dy else 1 - frac[..., 1])
                     * (frac[..., 2] if dx else 1 - frac[..., 2]))
                kz, ky, kx = base[..., 0] + dz, base[..., 1] + dy, base[..., 2] + dx
                neg = kx < 0
                kz = torch.where(neg, -kz, kz) % m
                ky = torch.where(neg, -ky, ky) % m
                kx = torch.where(neg, -kx, kx)
                ok = kx <= nxf - 1
                v = flat[(kz * m + ky) * nxf + kx.clamp(0, nxf - 1)]
                v = torch.where(neg, v.conj(), v)
                out = out + torch.where(ok, w, torch.zeros_like(w)) * v
    out = torch.where(flip, out.conj(), out)
    inside = (q * q).sum(-1) <= (m // 2) ** 2
    return torch.where(inside, out, torch.zeros_like(out))


def slice_coords(R, n):
    """(..., n, n//2+1, 3) wavenumbers (z, y, x) of the central slice of
    pose R (..., 3, 3) on the unpadded grid."""
    ky, kx = wavenumbers(n, R.device, R.dtype)
    q = (kx[None, :, None] * R[..., None, None, 0, :]
         + ky[:, None, None] * R[..., None, None, 1, :])
    return q.flip(-1)


def project(Fvol, R, n):
    """Spectra (..., n, n//2+1) of the central slices of poses R."""
    return gather_3d(Fvol, slice_coords(R, n), scale=float(Fvol.shape[0] // n))


def wavelength(voltage_kv):
    v = float(voltage_kv) * 1e3
    return 12.2639 / math.sqrt(v + 0.97845e-6 * v * v)


def ctf(pts, n, pixel, df1, df2, angast_deg, voltage_kv=300.0, cs_mm=2.7,
        w=0.07, phase=0.0):
    """CTF at wavenumbers pts (..., 2) = (ky, kx); the defocus arguments
    (Å, degrees) broadcast against the points' leading axes."""
    gy = pts[..., 0] / (n * pixel)
    gx = pts[..., 1] / (n * pixel)
    g2 = gy * gy + gx * gx
    azim = torch.atan2(gy, gx)
    df = 0.5 * (df1 + df2 + (df1 - df2)
                * torch.cos(2.0 * (azim - torch.deg2rad(torch.as_tensor(
                    angast_deg, dtype=pts.dtype, device=pts.device)))))
    lam = wavelength(voltage_kv)
    chi = (math.pi * lam * g2 * df
           - 0.5 * math.pi * cs_mm * 1e7 * lam ** 3 * g2 * g2 + phase)
    return -torch.sin(chi + math.atan2(w, math.sqrt(max(1.0 - w * w, 0.0))))


def half_plane(n, device, dtype=torch.float32):
    """(n, n//2+1, 2) wavenumbers (ky, kx) of the rfft half-plane."""
    ky, kx = wavenumbers(n, device, dtype)
    return torch.stack(torch.broadcast_tensors(ky[:, None], kx[None, :]), -1)


def shift_phase(pts, shifts, n):
    """exp(-2 pi i g.s / n) for points (..., P, 2) and shifts (..., 2)
    broadcast over the points: moves content by +s."""
    ph = (-2.0 * math.pi / n) * (pts[..., 0] * shifts[..., 0, None]
                                 + pts[..., 1] * shifts[..., 1, None])
    return torch.polar(torch.ones_like(ph), ph)


def band_points(n, pixel, low_res, high_res, device, dtype=torch.float32):
    """(G, 2) integer wavenumbers (ky, kx) of the half-plane strictly inside
    the resolution annulus (Å), below Nyquist, without the redundant
    kx = 0, ky < 0 half-line."""
    hp = half_plane(n, device, dtype).reshape(-1, 2)
    g = torch.sqrt((hp * hp).sum(-1)) / (n * pixel)
    keep = (g > 1.0 / low_res) & (g < 1.0 / high_res) & (g < 0.5 / pixel)
    keep &= ~((hp[:, 1] == 0) & (hp[:, 0] < 0))
    return hp[keep]


def gather_2d(F, pts):
    """Values of spectra F (..., n, n//2+1) at integer half-plane
    wavenumbers pts (G, 2) with kx >= 0: (..., G)."""
    n = F.shape[-2]
    iy = pts[:, 0].round().to(torch.int64) % n
    ix = pts[:, 1].round().to(torch.int64)
    return F[..., iy, ix]


def smoothstep(x):
    x = torch.clamp(x, 0.0, 1.0)
    return 0.5 - 0.5 * torch.cos(math.pi * x)


def soft_sphere(n, radius, edge, device, dtype=torch.float32):
    ax = torch.arange(n, device=device, dtype=dtype) - n // 2
    r = torch.sqrt(ax[:, None, None] ** 2 + ax[None, :, None] ** 2
                   + ax[None, None, :] ** 2)
    return 1.0 - smoothstep((r - radius) / edge)


def lowpass_3d(vol, pixel, resolution, width=0.01):
    """Cosine low-pass of a volume to `resolution` Å."""
    n = vol.shape[-1]
    kw = dict(device=vol.device, dtype=vol.dtype)
    fz = torch.fft.fftfreq(n, **kw).reshape(n, 1, 1)
    fy = torch.fft.fftfreq(n, **kw).reshape(1, n, 1)
    fx = torch.fft.rfftfreq(n, **kw).reshape(1, 1, -1)
    r = torch.sqrt(fz * fz + fy * fy + fx * fx)
    filt = 1.0 - smoothstep((r - pixel / resolution) / width)
    return torch.fft.irfftn(torch.fft.rfftn(vol) * filt, s=vol.shape)
