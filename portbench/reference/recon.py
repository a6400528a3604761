"""Plain Fourier insertion, for judging the system's accumulators.

Each particle spectrum is centred by its shift, weighted by its CTF and
spread by trilinear weights onto the pad-times oversampled 3D grid of its
half set (numerator += w CTF X, denominator += w CTF^2), Friedel mates of
points with x < 0 folded onto x >= 0.

`round_to` rounds every inserted value to a lower precision before it is
summed (the control of the comparison); the sums stay in the working dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import fourier as rf


def _insert(acc_num, acc_den, q32, vals, c2, half, m):
    """Scatter vals (B, P) and c2 (B, P) at padded wavenumbers q32 (B, P,
    3) into the stacked halves acc_num, acc_den (2, m, m, m//2+1).

    Which side of the Friedel plane a sample takes, its corners and whether
    it lies inside the Nyquist sphere are decided on the float32
    coordinates: a sample exactly on that sphere (every image has two, at
    (-n/2, 0) and (0, n/2)) is kept or dropped by their last bit, as the
    insertion under test decides it. The weights and sums are in the
    accumulators' dtype."""
    dtype = acc_den.dtype
    nxf = m // 2 + 1
    size = m * m * nxf
    flip = q32[..., 2] < 0
    qs = torch.where(flip[..., None], -q32, q32)
    vals = torch.where(flip, vals.conj(), vals)
    base32 = torch.floor(qs)
    frac = qs.to(dtype) - base32.to(dtype)
    base = base32.to(torch.int64)
    inside = (q32 * q32).sum(-1) <= (m // 2) ** 2
    off = (half.to(torch.int64) * size)[:, None]
    num = acc_num.reshape(-1)
    den = acc_den.reshape(-1)
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
                w = torch.where((kx <= nxf - 1) & inside, w, torch.zeros_like(w))
                v = torch.where(neg, vals.conj(), vals)
                idx = (off + (kz * m + ky) * nxf + kx.clamp(0, nxf - 1)).reshape(-1)
                num.index_add_(0, idx, (w * v).reshape(-1))
                den.index_add_(0, idx, (w * c2).reshape(-1))


def accumulate(images, rotations, shifts, ctf_args, half, weights, pad,
               pixel, batch=256, round_to=None, dtype=torch.float64):
    """Accumulators (num (2, m, m, m//2+1) complex, den real), m = pad*n,
    of real images (B, n, n) at float32 rotations (B, 3, 3), centring shifts
    (B, 2) px, CTF arguments ctf_args (B, 3) = (df1, df2, angast), half
    ids (B,) and weights (B,), in `dtype`, inserted `batch` rows at a
    time."""
    B, n = images.shape[0], images.shape[-1]
    m = pad * n
    dev = images.device
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    acc_num = torch.zeros((2, m, m, m // 2 + 1), dtype=cdt, device=dev)
    acc_den = torch.zeros((2, m, m, m // 2 + 1), dtype=dtype, device=dev)
    hp = rf.half_plane(n, dev, dtype)
    for lo in range(0, B, batch):
        sl = slice(lo, min(lo + batch, B))
        X = rf.image_to_fourier(images[sl].to(dtype))
        s = shifts[sl].to(dtype)
        ph = (-2.0 * np.pi / n) * (hp[..., 0] * s[:, 0, None, None]
                                   + hp[..., 1] * s[:, 1, None, None])
        X = X * torch.polar(torch.ones_like(ph), ph)
        ca = ctf_args[sl].to(dtype)
        c = rf.ctf(hp[None], n, pixel, ca[:, 0, None, None], ca[:, 1, None, None],
                   ca[:, 2, None, None])
        w = weights[sl].to(dtype)[:, None, None]
        vals, c2 = X * c * w, c * c * w
        if round_to is not None:
            vals = torch.complex(vals.real.to(round_to).to(dtype),
                                 vals.imag.to(round_to).to(dtype))
            c2 = c2.to(round_to).to(dtype)
        q = rf.slice_coords(rotations[sl].to(torch.float32), n) * pad
        _insert(acc_num, acc_den, q.reshape(q.shape[0], -1, 3),
                vals.reshape(vals.shape[0], -1), c2.reshape(c2.shape[0], -1),
                half[sl], m)
    return acc_num, acc_den













def radius_rfft(shape, device, dtype=torch.float64):
    """|k| in wavenumbers over an rfft layout of the full cubic shape."""
    n = shape[-1]
    k = torch.fft.fftfreq(n, d=1.0 / n, device=device, dtype=dtype)
    kx = torch.arange(n // 2 + 1, device=device, dtype=dtype)
    return torch.sqrt(k[:, None, None] ** 2 + k[None, :, None] ** 2
                      + kx[None, None, :] ** 2)


def rel_err(a, b, k_max=None):
    """Relative L2 gap of a against b, over the whole array or, for arrays
    on an rfft grid (m, m, m//2+1), at wavenumbers below k_max."""
    a = a.to(b.dtype)
    if k_max is not None:
        keep = radius_rfft((b.shape[0],) * 3, b.device) < k_max
        a, b = a[keep], b[keep]
    return float((a - b).norm() / b.norm())


def rounded(x, to):
    """x with its values (real and imaginary parts) rounded to dtype `to`."""
    if x.is_complex():
        return torch.complex(x.real.to(to).to(x.real.dtype),
                             x.imag.to(to).to(x.real.dtype))
    return x.to(to).to(x.dtype)
