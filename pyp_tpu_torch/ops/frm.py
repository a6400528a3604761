"""FRM projection matching — the torch port of pyp_tpu/ops/frm.py, the
default pose-search engine of the refinement loop.

  1. Each particle spectrum is Wiener-restored on its Cartesian grid and
     resampled onto rings (r, psi): by one dense Dirichlet interpolation
     matrix W (exact for an n-support image) while W stays under 512 MiB,
     else by an oversampled FFT and a 16-tap Keys bicubic gather
     (`polar_sample_gather`). PYP_TPU_FRM_POLAR=matmul|gather|auto
     overrides the choice, as it does in the JAX package.
  2. The direction bank holds, per lattice direction, the psi-FFT of the
     reference's central-slice ring values (`_bank_tables`), built once
     per iteration in blocks of 128 directions.
  3. With both sides polar an in-plane rotation is a circular shift along
     psi, so all psi are scored at once: a ring contraction per psi
     harmonic (`_num_hat`, bf16-rounded inputs, f32 products and sums),
     an upsampled inverse FFT along psi, a psi-independent NCC
     denominator, and a running first-best argmax over shift candidates
     and direction blocks (`_match_core`).
  4. Shifts: the first (global) round marginalizes over a coarse shift
     grid; every round then scores a fine per-particle grid at the matched
     orientation (`_refine_shifts`).

Every op is a torch op (cuFFT and cuBLAS on a card; the JAX package left
them to XLA too). Matmuls run in float32 with TF32 off on the card, as the
JAX package's CPU path computes them. The JAX functions `_frm_refine_jit` and
`_score_directions_jit` are `_frm_refine_core` and `_score_directions`
here; `_crop_jit` is `core.fft.fourier_crop` in `FrmConfig.crop_stack`.
The public shift sign matches the JAX package's: poses carry the centering
translation (content sits at -s).
"""

from __future__ import annotations

import contextlib
import math
import os
import threading

import numpy as np
import torch

from pyp_tpu_torch import as_f32, resolve_device
from pyp_tpu_torch.core import ctf as ctf_model
from pyp_tpu_torch.core.fft import fourier_crop
from pyp_tpu_torch.core.geometry import euler_to_matrix
from pyp_tpu_torch.ops.fourier_slice import gather_3d_hermitian
from pyp_tpu_torch.ops.refine3d import (
    RefineResult,
    _ctf_at_points,
    make_directions,
    make_shift_grid,
)


_TF32_LOCK = threading.Lock()
_tf32_entries = 0
_tf32_saved = False


@contextlib.contextmanager
def _fp32_matmul():
    """Full float32 matmuls (TF32 off) on a card inside the public FRM
    entry points, which it decorates. The switch is process-wide, so the
    entries of every thread are counted under one lock: the first in
    saves the setting and clears it, the last out restores it, and no
    thread inside ever sees TF32 on."""
    global _tf32_entries, _tf32_saved
    with _TF32_LOCK:
        if _tf32_entries == 0:
            _tf32_saved = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
        _tf32_entries += 1
    try:
        yield
    finally:
        with _TF32_LOCK:
            _tf32_entries -= 1
            if _tf32_entries == 0:
                torch.backends.cuda.matmul.allow_tf32 = _tf32_saved


def _abs2(z):
    """|z|^2 as the JAX package's FRM computes it (jnp.abs(z) ** 2, not
    refine3d's re^2 + im^2), so the two round alike."""
    return z.abs() ** 2


# ---------------------------------------------------------------------------
# geometry (host-side numpy constants, the same code as the JAX package's)
# ---------------------------------------------------------------------------

def make_rings(n: int, pixel_size: float, low_res: float, high_res: float):
    """Integer ring radii (unpadded wavenumber units) inside the band."""
    r_min = max(2, int(np.ceil(n * pixel_size / low_res)))
    r_max = min(n // 2 - 2, int(np.floor(n * pixel_size / high_res)))
    if r_max < r_min:
        raise ValueError(f"empty band: rings [{r_min}, {r_max}]")
    return np.arange(r_min, r_max + 1, dtype=np.float32)


def default_n_psi(radii) -> int:
    """Power-of-two psi count >= the outer ring's Nyquist rate (2*pi*r)."""
    need = 2.0 * np.pi * float(np.max(radii))
    return int(2 ** np.ceil(np.log2(max(need, 32.0))))


def ring_weights(radii) -> np.ndarray:
    """Per-ring quadrature weights ~ r, normalized to sum 1."""
    r = np.asarray(radii, dtype=np.float32)
    return r / r.sum()


def _dirichlet_kernel(t, n):
    """Exact interpolation kernel for a centered n-support image spectrum:
    K(t) = (1/n) sin(pi t)/sin(pi t / n) * exp(-i pi t / n); |t| < n here,
    so t = 0 is the only removable singularity."""
    t = np.asarray(t, dtype=np.float64)
    small = np.abs(t) < 1e-9
    denom = np.where(small, 1.0, np.sin(np.pi * t / n))
    mag = np.where(small, 1.0, np.sin(np.pi * t) / (n * denom))
    return mag * np.exp(-1j * np.pi * t / n)


def polar_matrix(n: int, radii, n_psi: int):
    """Dense complex interpolation matrix W (R*P, n*n) from a centered
    full-grid spectrum (ky-major, fftfreq order) to its polar samples at
    (gy, gx) = r (sin a_j, cos a_j), a_j = 2 pi j / n_psi. Returns (W_re,
    W_im) float32 numpy arrays."""
    radii = np.asarray(radii, dtype=np.float64)
    R, P = len(radii), n_psi
    ang = 2.0 * np.pi * np.arange(P) / P
    gy = radii[:, None] * np.sin(ang)[None, :]   # (R, P)
    gx = radii[:, None] * np.cos(ang)[None, :]
    ky = np.fft.fftfreq(n) * n                   # (n,)
    kx = np.fft.fftfreq(n) * n
    Ky = _dirichlet_kernel(ky[None, :] - gy.reshape(-1)[:, None], n)  # (RP, n)
    Kx = _dirichlet_kernel(kx[None, :] - gx.reshape(-1)[:, None], n)  # (RP, n)
    W = Ky[:, :, None] * Kx[:, None, :]          # (RP, n, n) complex
    W = W.reshape(R * P, n * n)
    return (np.ascontiguousarray(W.real.astype(np.float32)),
            np.ascontiguousarray(W.imag.astype(np.float32)))


def polar_points(radii, n_psi):
    """(R, P, 2) float32 (gy, gx) wavenumber coordinates of the polar grid."""
    radii = np.asarray(radii, dtype=np.float32)
    ang = 2.0 * np.pi * np.arange(n_psi, dtype=np.float32) / n_psi
    gy = radii[:, None] * np.sin(ang)[None, :]
    gx = radii[:, None] * np.cos(ang)[None, :]
    return np.stack([gy, gx], axis=-1)


def ring_weights_from_fsc(fsc_curve, radii, n: int):
    """Cref = sqrt(2C/(1+C)) SSNR weights at the ring radii; `n` is the
    grid the curve was measured on (the data box: ring radii are data
    wavenumbers, preserved by the Fourier crop)."""
    curve = np.clip(np.asarray(fsc_curve, dtype=np.float64), 0.0, 1.0)
    n_bins = len(curve)
    r = np.asarray(radii, dtype=np.float64) / n  # cycles/px
    idx = np.clip((r / 0.5 * n_bins).astype(int), 0, n_bins - 1)
    cref = np.sqrt(2.0 * curve / (1.0 + curve))
    return cref[idx].astype(np.float32)


# ---------------------------------------------------------------------------
# polar sampling
# ---------------------------------------------------------------------------

def _checkerboard(n: int, device):
    i = torch.arange(n, device=device)
    return 1.0 - 2.0 * ((i[:, None] + i[None, :]) % 2).to(torch.float32)


def image_to_fourier_full(imgs):
    """Centered full-grid 2D spectra (..., n, n) complex64."""
    return torch.fft.fft2(imgs.to(torch.float32)) * _checkerboard(
        imgs.shape[-1], imgs.device)


def _polar_matmul(Xr, Xi, W_re, W_im):
    """(Xr + i Xi) @ (W_re + i W_im).T as four real matmuls."""
    return torch.complex(Xr @ W_re.T - Xi @ W_im.T, Xr @ W_im.T + Xi @ W_re.T)


@_fp32_matmul()
def polar_transform(stack, W_re, W_im):
    """(B, n, n) real images -> (B, R*P) complex polar spectrum samples."""
    X = image_to_fourier_full(stack)
    B = X.shape[0]
    return _polar_matmul(X.real.reshape(B, -1), X.imag.reshape(B, -1),
                         W_re, W_im)


def _oversampled_spectra(stack, os: int):
    """Centered full-grid spectra of `os`-times zero-padded images:
    (B, os*n, os*n) complex64."""
    n = stack.shape[-1]
    N = os * n
    off = (N - n) // 2
    x = torch.nn.functional.pad(stack.to(torch.float32),
                                (off, N - n - off, off, N - n - off))
    return torch.fft.fft2(x) * _checkerboard(N, x.device)


def _keys_cubic_weights(t):
    """Catmull-Rom (Keys, a=-0.5) weights for taps (-1, 0, +1, +2) at
    fractional position t in [0, 1)."""
    t2 = t * t
    t3 = t2 * t
    return (-0.5 * t3 + t2 - 0.5 * t,
            1.5 * t3 - 2.5 * t2 + 1.0,
            -1.5 * t3 + 2.0 * t2 + 0.5 * t,
            0.5 * t3 - 0.5 * t2)


def _bicubic_wrap_take(Y, p):
    """Bicubic (Keys) interpolation of (B, N, N) periodic full-fft grids at
    wavenumber points p (..., 2) = (gy, gx) shared across the batch: each
    of the 16 taps is one index_select along the flattened grid, with the
    indices wrapped by floor-mod."""
    N = Y.shape[-1]
    p0f = torch.floor(p)
    f = p - p0f
    p0 = p0f.to(torch.int64)
    wys = _keys_cubic_weights(f[..., 0])
    wxs = _keys_cubic_weights(f[..., 1])
    Yf = Y.reshape(Y.shape[0], -1)
    out = None
    for dy in (-1, 0, 1, 2):
        wy = wys[dy + 1]
        iy = torch.remainder(p0[..., 0] + dy, N)
        for dx in (-1, 0, 1, 2):
            wx = wxs[dx + 1]
            ix = torch.remainder(p0[..., 1] + dx, N)
            v = Yf.index_select(1, (iy * N + ix).reshape(-1))
            v = v.reshape((Y.shape[0],) + p.shape[:-1])
            term = (wy * wx)[None] * v
            out = term if out is None else out + term
    return out


def polar_sample_gather(stack, ctf_params, pts, n, pixel_size, voltage_kv,
                        cs_mm, amplitude_contrast, wiener, os: int = 2):
    """Wiener-restored polar spectra without the dense W: restore on the
    n-grid first (pointwise, in the rfft layout), then interpolate the
    restored field bicubically from its `os`-times oversampled spectrum,
    then take the ring-mean restored confidence from the exact CTF at the
    polar points. Restoring before interpolating matters: the data nodes
    are C[k]*S[k], and their interpolant off the nodes is not C(p)*S(p)
    where the CTF oscillates near the grid rate.

    Returns (Xp (B, R, K) complex64, conf_mean (B, R) in [0, 1])."""
    Cr = ctf_model.ctf_2d(
        (n, n), pixel_size, ctf_params[:, 0], ctf_params[:, 1],
        ctf_params[:, 2], voltage_kv, cs_mm, w=amplitude_contrast,
        phase_shift_rad=ctf_params[:, 3], rfft=True)          # (B, n, nxf)
    xw = torch.fft.irfft2(torch.fft.rfft2(stack.to(torch.float32))
                          * (Cr / (Cr * Cr + wiener)), s=(n, n))
    Y = _oversampled_spectra(xw, os)
    Xp = _bicubic_wrap_take(Y, pts * float(os))               # (B, R, K)
    cp = ctf_params[:, :, None, None]
    C = _ctf_at_points(pts[None], n, pixel_size, cp[:, 0], cp[:, 1],
                       cp[:, 2], voltage_kv, cs_mm, amplitude_contrast,
                       cp[:, 3])                               # (B, R, K)
    conf = C * C / (C * C + wiener)
    return Xp, torch.clamp(conf.mean(dim=-1), 0.0, 1.0)


def shift_phasor_polar(pts, shifts, n):
    """exp(+2 pi i (gy sy + gx sx) / n) at polar points: (..., R, P) for
    shifts (..., 2) = (sy, sx)."""
    ph = (2.0 * math.pi / n) * (
        pts[..., 0] * shifts[..., 0, None, None]
        + pts[..., 1] * shifts[..., 1, None, None])
    return torch.complex(torch.cos(ph), torch.sin(ph))


def _restore_polar(stack, ctf_params, W_re, W_im, pts, ring_w, n: int,
                   n_psi: int, pixel_size: float, voltage_kv: float,
                   cs_mm: float, amplitude_contrast: float, wiener: float,
                   polar_gather: bool = False):
    """Wiener-restored polar spectra (B, R, n_psi) and per-particle ring
    weights (B, R): ring_w times the ring-mean restored confidence
    C^2/(C^2 + wiener). The front half of every FRM match."""
    if polar_gather:
        Xp, conf_mean = polar_sample_gather(
            stack, ctf_params, pts, n, pixel_size, voltage_kv, cs_mm,
            amplitude_contrast, wiener)
        return Xp, ring_w[None, :] * conf_mean
    B = stack.shape[0]
    R = ring_w.shape[0]
    X = image_to_fourier_full(stack)
    Cg = ctf_model.ctf_2d(
        (n, n), pixel_size, ctf_params[:, 0], ctf_params[:, 1],
        ctf_params[:, 2], voltage_kv, cs_mm, w=amplitude_contrast,
        phase_shift_rad=ctf_params[:, 3], rfft=False)          # (B, n, n)
    conf = Cg * Cg / (Cg * Cg + wiener)
    Xw = X * (Cg / (Cg * Cg + wiener))
    Xp = _polar_matmul(Xw.real.reshape(B, -1), Xw.imag.reshape(B, -1),
                       W_re, W_im).reshape(B, R, n_psi)
    # ring-mean confidence: the real part of the complex-kernel
    # interpolation of a real array
    conf_rings = (conf.reshape(B, -1) @ W_re.T).reshape(B, R, n_psi)
    return Xp, ring_w[None, :] * torch.clamp(conf_rings.mean(dim=-1), 0.0, 1.0)


# ---------------------------------------------------------------------------
# direction bank
# ---------------------------------------------------------------------------

_BANK_BLOCK = 128


def _slice_ring_points(directions, pts):
    """(D, R, P, 3) xyz wavenumber coords of each direction's polar ring
    points: r cos(a) ex0(d) + r sin(a) ey0(d), R0 = R(phi, theta, 0)."""
    R0 = euler_to_matrix(directions[:, 0], directions[:, 1],
                         torch.zeros_like(directions[:, 0]))
    ex = R0[:, 0, :]
    ey = R0[:, 1, :]
    return (pts[None, ..., 1, None] * ex[:, None, None, :]
            + pts[None, ..., 0, None] * ey[:, None, None, :])


def direction_bank(Fref, directions, radii, n_psi: int, n: int):
    """Central-slice ring values for every lattice direction: (D, R, P)
    complex, trilinear from the padded reference spectrum."""
    dev = Fref.device
    directions = torch.as_tensor(np.asarray(directions, dtype=np.float32),
                                 device=dev)
    pts = torch.as_tensor(polar_points(radii, n_psi), device=dev)
    q = _slice_ring_points(directions, pts)
    return gather_3d_hermitian(Fref, q.flip(-1), scale=float(Fref.shape[0] // n))


def _bank_tables(Fref, directions, pts, n: int):
    """FUc = conj(fft(conj(U))) along psi (the table of the psi
    correlation) and u2sum = per-ring power sums of U, for U the (D, R, P)
    ring values. Built in blocks of 128 directions so the (D, R, P, 3)
    coordinate grid and the full U never exist at once."""
    vol_pad = Fref.shape[0] // n
    fucs, u2s = [], []
    for d0 in range(0, directions.shape[0], _BANK_BLOCK):
        q = _slice_ring_points(directions[d0:d0 + _BANK_BLOCK], pts)
        U = gather_3d_hermitian(Fref, q.flip(-1), scale=float(vol_pad))
        fucs.append(torch.fft.fft(U.conj(), dim=-1).conj())
        u2s.append(_abs2(U).sum(dim=-1))
    return torch.cat(fucs), torch.cat(u2s)


class FrmBank:
    """Per-(reference, iteration) scoring tables on the reference's device:
    FUc (D, R, K) complex64, u2sum (D, R), and the host-side directions
    (D, 2) and viewing axes (D, 3). Only the psi-FFT table is kept: ring
    values U are recovered exactly as conj(ifft(conj(FUc))) for the rows
    that need them."""

    def __init__(self, Fref, directions, radii, n_psi: int, n: int):
        self.directions = np.asarray(directions, dtype=np.float32)
        self.radii = np.asarray(radii, dtype=np.float32)
        self.n_psi = int(n_psi)
        self.n = int(n)
        dev = Fref.device
        pts = torch.as_tensor(polar_points(radii, n_psi), device=dev)
        self.FUc, self.u2sum = _bank_tables(
            Fref, torch.as_tensor(self.directions, device=dev), pts, self.n)
        R0 = euler_to_matrix(torch.as_tensor(self.directions[:, 0]),
                             torch.as_tensor(self.directions[:, 1]),
                             torch.zeros(len(self.directions)))
        self.axes = R0[:, 2, :].numpy()                         # (D, 3)


# ---------------------------------------------------------------------------
# matching + shifts
# ---------------------------------------------------------------------------

def _upsampled_ifft(h, upsample: int):
    """Real part of the inverse FFT along the last axis, trigonometrically
    interpolated onto an `upsample`-times finer grid: the bins
    h[..., :K//2] stay low and h[..., K//2:] (Nyquist included) move to
    the top, with zeros between."""
    if upsample == 1:
        return torch.fft.ifft(h, dim=-1).real
    K = h.shape[-1]
    Ku = K * upsample
    pad = h.new_zeros(h.shape[:-1] + (Ku,))
    pad[..., : K // 2] = h[..., : K // 2]
    pad[..., Ku - (K - K // 2):] = h[..., K // 2:]
    return torch.fft.ifft(pad, dim=-1).real * upsample


def _bf16_round(x):
    """float32 values rounded to bfloat16 (nearest even) and back."""
    return x.to(torch.bfloat16).to(torch.float32)


def _bank_planes(fu):
    """bf16-rounded real and imaginary planes of a bank block (d, R, K),
    laid out (K, R, d) for the per-harmonic matmul."""
    return (_bf16_round(fu.real).permute(2, 1, 0),
            _bf16_round(fu.imag).permute(2, 1, 0))


def _num_hat_planes(FA_s, br, bi):
    ar = _bf16_round(FA_s.real).permute(2, 0, 1)          # (K, B, R)
    ai = _bf16_round(FA_s.imag).permute(2, 0, 1)
    re = torch.matmul(ar, br) - torch.matmul(ai, bi)       # (K, B, d)
    im = torch.matmul(ar, bi) + torch.matmul(ai, br)
    return torch.complex(re, im).permute(1, 2, 0)         # (B, d, K)


def _num_hat(FA_s, fu):
    """Ring contraction num[b, d, k] = sum_r FA[b, r, k] fu[d, r, k] with
    both operands rounded to bfloat16 and the products and sums in float32
    (the JAX package's bf16 einsum with preferred_element_type=float32)."""
    return _num_hat_planes(FA_s, *_bank_planes(fu))


def _match(Xp_shift_cands, ring_w, FUc, u2sum, dir_mask, d_block: int,
           upsample: int, psi_mask=None):
    """Best (shift candidate, direction, psi) per particle for candidate
    spectra (S, B, R, P) and per-particle ring weights (B, R). Returns
    (score, shift candidate index, direction index, psi index on the
    upsampled grid), each (B,)."""
    A = Xp_shift_cands.conj() * ring_w[None, :, :, None]
    FA = torch.fft.fft(A, dim=-1)                          # (S, B, R, K)
    xnorm2 = (ring_w[:, :, None] * _abs2(Xp_shift_cands[0])).sum(dim=(1, 2))
    return _match_core(FA, xnorm2, ring_w, FUc, u2sum, dir_mask, d_block,
                       upsample, psi_mask)


def _match_harmonics(FA, ring_w, Xp0, FUc, u2sum, dir_mask, d_block: int,
                     upsample: int, psi_mask=None):
    """_match with a precomputed (possibly harmonic-truncated) FA
    (S, B, R, K'); Xp0 supplies the shift-invariant data norm."""
    xnorm2 = (ring_w[:, :, None] * _abs2(Xp0)).sum(dim=(1, 2))
    return _match_core(FA, xnorm2, ring_w, FUc, u2sum, dir_mask, d_block,
                       upsample, psi_mask)


def _match_core(FA, xnorm2, ring_w, FUc, u2sum, dir_mask, d_block: int,
                upsample: int, psi_mask=None):
    """Running first-best argmax over direction blocks of `d_block` (D a
    multiple of it; padded directions carry -inf in dir_mask), shift
    candidates (strict `>` across s) and the flattened (direction, psi)
    grid. Ties go to the first block, then the first s, then the first
    (d, psi) in d-major order — the JAX package's order."""
    S, B, R, K = FA.shape
    D = FUc.shape[0]
    Ku = K * upsample
    scores, idxs = [], []
    for d0 in range(0, D, d_block):
        u2 = u2sum[d0:d0 + d_block]
        m = dir_mask[:, d0:d0 + d_block]
        br, bi = _bank_planes(FUc[d0:d0 + d_block])
        # psi-independent NCC denominator: full-circle power sums
        den = torch.sqrt(torch.clamp(ring_w @ u2.T, min=1e-20)
                         * xnorm2[:, None])                      # (B, d)
        best = torch.full((B,), float("-inf"), device=FA.device)
        idx = torch.zeros(B, dtype=torch.int64, device=FA.device)
        for s in range(S):  # running max bounds memory
            num = _upsampled_ifft(_num_hat_planes(FA[s], br, bi), upsample)
            v = num / den[..., None] + m[..., None]
            if psi_mask is not None:  # local mode: psi prior (B, Ku)
                v = v + psi_mask[:, None, :]
            v = v.reshape(B, -1)
            i = torch.argmax(v, dim=1)
            val = torch.gather(v, 1, i[:, None])[:, 0]
            upd = val > best
            idx = torch.where(upd, s * (d_block * Ku) + i, idx)
            best = torch.maximum(best, val)
        scores.append(best)
        idxs.append(idx)
    scores = torch.stack(scores)                           # (n_blocks, B)
    idxs = torch.stack(idxs)
    blk = torch.argmax(scores, dim=0)                      # (B,)
    best = torch.gather(scores, 0, blk[None])[0]
    flat = torch.gather(idxs, 0, blk[None])[0]
    s_idx = flat // (d_block * Ku)
    rem = flat % (d_block * Ku)
    return best, s_idx, blk * d_block + rem // Ku, rem % Ku


def _roll_psi(U, psi_deg):
    """out(a) = U(a - psi): continuous circular shift along the psi axis
    via harmonic phases."""
    K = U.shape[-1]
    k = torch.as_tensor((np.fft.fftfreq(K) * K).astype(np.float32),
                        device=U.device)
    ph = -2.0 * math.pi * k[None, None, :] * (psi_deg[:, None, None] / 360.0)
    rot = torch.complex(torch.cos(ph), torch.sin(ph))
    return torch.fft.ifft(torch.fft.fft(U, dim=-1) * rot, dim=-1)


def _refine_shifts(Xp_raw, ring_w, U_best, u2_best, psi_deg, pts,
                   shift_grids, n: int):
    """Best absolute shift per particle at the matched (direction, psi),
    over per-particle candidate grids shift_grids (B, S, 2): one batched
    (R*P) x S contraction. Content shifted by +s carries spectrum phase
    e^{-2 pi i g.s/n}; removing it multiplies conj(Xp) by e^{-i ph}, so
    num = Re(A) cos(ph) + Im(A) sin(ph). Returns (shifts (B, 2), scores)."""
    w = ring_w[:, :, None]
    M = _roll_psi(U_best, psi_deg)                         # (B, R, P)
    A = Xp_raw.conj() * M * w
    B_ = A.shape[0]
    gy = pts[..., 0].reshape(-1)
    gx = pts[..., 1].reshape(-1)
    ph = (2.0 * math.pi / n) * (
        gy[None, :, None] * shift_grids[:, None, :, 0]
        + gx[None, :, None] * shift_grids[:, None, :, 1])  # (B, RP, S)
    num = (torch.bmm(A.real.reshape(B_, 1, -1), torch.cos(ph))
           + torch.bmm(A.imag.reshape(B_, 1, -1), torch.sin(ph)))[:, 0]
    den = torch.sqrt((w * _abs2(Xp_raw)).sum(dim=(1, 2))
                     * (ring_w * u2_best).sum(dim=1) + 1e-20)
    s = num / den[:, None]
    idx = torch.argmax(s, dim=1)
    rows = torch.arange(B_, device=s.device)
    return shift_grids[rows, idx], s[rows, idx]


def _frm_refine_core(
    stack, ctf_params, W_re, W_im, pts, ring_w, FUc, u2sum, dir_table,
    bank_axes, shift_grid, coarse_shifts, init_shifts, init_axes,
    init_psi_deg, ring_cref,
    n: int, n_psi: int, pixel_size: float, voltage_kv: float, cs_mm: float,
    amplitude_contrast: float, rounds: int, d_block: int, upsample: int,
    cone_deg, coarse_step: float = 0.0, wiener: float = 0.1,
    polar_gather: bool = False,
):
    """One batch of the FRM search on the batch's device, in the engine's
    internal conventions (crop-grid pixels, shifts as +content offsets).
    Returns (poses (B, 5), scores (B,))."""
    B = stack.shape[0]
    # CTF restored on the sampled grid: the model side is the CTF-free
    # slice U, and the restored-band confidence enters the ring weights
    Xp, wr = _restore_polar(
        stack, ctf_params, W_re, W_im, pts, ring_w * ring_cref, n, n_psi,
        pixel_size, voltage_kv, cs_mm, amplitude_contrast, wiener,
        polar_gather)

    D = FUc.shape[0]
    dev = stack.device
    if cone_deg is None:
        dir_mask = torch.zeros((B, D), device=dev)
    else:
        cosim = init_axes @ bank_axes.T
        dir_mask = torch.where(
            cosim >= float(np.cos(np.radians(cone_deg))),
            torch.zeros((), device=dev),
            torch.full((), float("-inf"), device=dev))

    def psi_prior(Ku):
        # local mode restricts psi too: a full-360 in-plane search would
        # let a spurious rotation overfit
        if cone_deg is None:
            return None
        win = max(float(cone_deg), 2.0 * 360.0 / Ku)
        ang = torch.arange(Ku, dtype=torch.float32, device=dev) * (360.0 / Ku)
        d = torch.remainder(ang[None, :] - init_psi_deg[:, None] + 180.0,
                            360.0) - 180.0
        return torch.where(d.abs() <= win, torch.zeros((), device=dev),
                           torch.full((), float("-inf"), device=dev))

    pad = (-D) % d_block
    if pad:
        FUc = torch.nn.functional.pad(FUc, (0, 0, 0, 0, 0, pad))
        u2sum = torch.nn.functional.pad(u2sum, (0, 0, 0, pad))
        dir_mask = torch.nn.functional.pad(dir_mask, (0, pad),
                                           value=float("-inf"))

    shifts = init_shifts
    scores = d_idx = psi_deg = None
    radii_dev = pts[:, 0, 1]  # (R,) ring radii (gx at angle 0)
    # the coarse round matches on the low psi harmonics only: a ring of
    # radius r carries ~2 pi r meaningful harmonics, and the damped coarse
    # match does not use the outer rings' detail
    k0 = min(n_psi, 64)
    FUc0 = torch.cat([FUc[..., : k0 // 2], FUc[..., -k0 // 2:]], dim=-1)
    # local mode starts from sub-pixel table shifts: no coarse round
    first_round = 1 if (cone_deg is not None and rounds > 1) else 0
    rows = torch.arange(B, device=dev)
    for rnd in range(first_round, rounds):
        if rnd == 0:
            # unknown shift: marginalize over a coarse absolute shift grid,
            # with mild ring damping for the residual within one cell
            cand = coarse_shifts[:, None, :] + shifts[None]     # (S, B, 2)
            step = max(float(coarse_step), 1e-3)
            damp = torch.exp(-0.5 * (2.0 * math.pi * radii_dev
                                     * (step / 2.0) / n) ** 2)
            w_round = wr * torch.clamp(damp, min=1e-4)[None, :]
            fuc, k_round, up_round = FUc0, k0, 1
        else:
            cand = shifts[None]                                 # (1, B, 2)
            w_round = wr
            fuc, k_round, up_round = FUc, n_psi, upsample
        # content shift s puts phase e^{-2 pi i g.s/n} on the spectrum;
        # multiply by the +phasor to undo each candidate
        Xc = Xp[None] * shift_phasor_polar(pts, cand, n)        # (S, B, R, P)
        if k_round < n_psi:
            FX = torch.fft.fft(Xc.conj() * w_round[None, :, :, None], dim=-1)
            FA = torch.cat([FX[..., : k_round // 2],
                            FX[..., -k_round // 2:]], dim=-1)
            scores, s_idx, d_idx, psi_idx = _match_harmonics(
                FA, w_round, Xc[0], fuc, u2sum, dir_mask, d_block, up_round,
                psi_prior(k_round * up_round))
        else:
            scores, s_idx, d_idx, psi_idx = _match(
                Xc, w_round, fuc, u2sum, dir_mask, d_block, up_round,
                psi_prior(k_round * up_round))
        shifts = cand[s_idx, rows]                              # (B, 2)
        psi_deg = psi_idx.to(torch.float32) * (360.0 / (k_round * up_round))
        # ring values of the selected directions, recovered exactly from
        # the psi-FFT table
        U_sel = torch.fft.ifft(FUc[d_idx].conj(), dim=-1).conj()
        shifts, scores = _refine_shifts(
            Xp, wr, U_sel, u2sum[d_idx], psi_deg, pts,
            shift_grid[None] + shifts[:, None, :], n)
    dirs = dir_table[d_idx]                                     # (B, 2)
    poses = torch.stack([dirs[:, 0], dirs[:, 1], psi_deg, shifts[:, 0],
                         shifts[:, 1]], dim=-1)
    return poses, scores


# ---------------------------------------------------------------------------
# configuration and public entry points
# ---------------------------------------------------------------------------

W_GATHER_BYTES = 512 * 2 ** 20


class FrmConfig:
    """Static search geometry and the polar interpolation matrix, on one
    device.

    Band-limited auto-crop: the search only needs wavenumbers up to r_max,
    so particles are Fourier-cropped to n ~ 2 (r_max + margin) before the
    polar transform; integer wavenumbers (and hence ring radii) survive the
    crop, W is built on the crop grid, and shifts convert by n / n_data.
    The reference volume stays full size (the bank gathers by wavenumber).
    """

    def __init__(self, n, pixel_size, low_res=25.0, high_res=8.0,
                 angular_step=7.5, symmetry="C1", n_psi=None,
                 shift_extent=6.0, shift_step=1.0, rounds=3,
                 voltage_kv=300.0, cs_mm=2.7, amplitude_contrast=0.07,
                 upsample=4, wiener=0.1, crop_margin=8, device="cuda"):
        self.device = dev = resolve_device(device)
        self.n_data = int(n)
        self.radii = make_rings(n, pixel_size, low_res, high_res)
        r_max = int(np.max(self.radii))
        self.n = min(int(n), int(np.ceil(
            (2 * r_max + max(0, int(crop_margin))) / 16.0)) * 16)
        self.crop = self.n / float(n)          # shift scale: data px -> crop px
        self.pixel_size = float(pixel_size) / self.crop
        self.n_psi = int(n_psi or default_n_psi(self.radii))
        self.ring_w = torch.as_tensor(ring_weights(self.radii), device=dev)
        self.directions = np.asarray(make_directions(angular_step, symmetry),
                                     dtype=np.float32)
        self.shift_grid = torch.as_tensor(
            make_shift_grid(shift_extent, shift_step) * self.crop, device=dev)
        self.rounds = int(rounds)
        self.upsample = int(upsample)
        # coarse shift-marginalization grid of the first match round
        self.coarse_step = max(float(shift_step),
                               float(shift_extent) / 3.0) * self.crop
        self.coarse_shifts = torch.as_tensor(
            make_shift_grid(shift_extent, self.coarse_step / self.crop)
            * self.crop, device=dev)
        self.wiener = float(wiener)
        self.voltage_kv = float(voltage_kv)
        self.cs_mm = float(cs_mm)
        self.amplitude_contrast = float(amplitude_contrast)
        # polar sampler: the dense W (R*n_psi, n^2) is exact, but its bytes
        # and FLOPs grow with the band; above 512 MiB the oversampled-FFT
        # gather sampler takes over. PYP_TPU_FRM_POLAR=matmul|gather|auto
        # overrides, the same switch as the JAX package's
        w_bytes = len(self.radii) * self.n_psi * self.n * self.n * 8
        mode = os.environ.get("PYP_TPU_FRM_POLAR", "auto").lower()
        self.polar_gather = (w_bytes > W_GATHER_BYTES if mode == "auto"
                             else mode == "gather")
        if self.polar_gather:
            self.W_re = self.W_im = torch.zeros((1, 1), device=dev)
        else:
            W_re, W_im = polar_matrix(self.n, self.radii, self.n_psi)
            self.W_re = torch.as_tensor(W_re, device=dev)
            self.W_im = torch.as_tensor(W_im, device=dev)
        self.pts = torch.as_tensor(polar_points(self.radii, self.n_psi),
                                   device=dev)

    def crop_stack(self, stack):
        """Fourier-crop data images (a tensor on this config's device) to
        the band-limited internal box."""
        if self.n == self.n_data:
            return stack.to(torch.float32)
        return fourier_crop(stack, (self.n, self.n))

    def bank(self, Fref) -> FrmBank:
        # vol_pad inside the bank derives from the FULL volume box
        return FrmBank(Fref, self.directions, self.radii, self.n_psi,
                       self.n_data)


def default_d_block(B: int, D: int, n_psi: int, upsample: int, device) -> int:
    """Directions per match block. On a card: as many as fit a quarter of
    the free device memory, at ~32 bytes of temporaries per (particle,
    direction, upsampled psi) — the complex padded spectrum, its inverse
    FFT, the real scores and their flattened copy. On the CPU: the JAX
    package's rule (a (B, d_block, K*upsample) float32 block of ~128 MB,
    between 8 and 64), so parity tests block the same way."""
    per_dir = max(1, B * n_psi * upsample)
    if torch.device(device).type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return int(max(8, min(D, (free // 4) // (32 * per_dir))))
    return max(8, min(64, (128 * 2 ** 20) // (4 * per_dir)))


@_fp32_matmul()
def frm_refine(stack, ctf_params, Fref, cfg: FrmConfig, bank: FrmBank = None,
               init_poses=None, prior_cone_deg=None, d_block: int = None,
               fsc_curve=None):
    """Full orientation + shift search for one particle batch on
    cfg.device. Returns (poses (B, 5) = (phi, theta, psi, sy, sx),
    scores (B,)).

    Without init_poses the search is global (every direction and psi);
    with init_poses and prior_cone_deg it is local (a direction cone and a
    psi window around each particle's pose, no coarse shift round). The
    bank is built once per refinement iteration and shared by all batches;
    fsc_curve (optional) applies Cref SSNR ring weights."""
    dev = cfg.device
    if bank is None:
        bank = cfg.bank(Fref)
    stack = cfg.crop_stack(as_f32(stack, dev))
    B = stack.shape[0]
    D = bank.FUc.shape[0]
    if d_block is None:
        d_block = default_d_block(B, D, cfg.n_psi, cfg.upsample, dev)
    if init_poses is not None:
        init_poses = as_f32(init_poses, dev)
        # poses carry the CENTERING translation (content sits at -s); the
        # engine's shifts are +content offsets: negate at this boundary
        init_shifts = -init_poses[:, 3:5] * cfg.crop
        R_i = euler_to_matrix(init_poses[:, 0], init_poses[:, 1],
                              init_poses[:, 2])
        init_axes = R_i[:, 2, :]
        init_psi_deg = init_poses[:, 2]
        cone = float(prior_cone_deg) if prior_cone_deg is not None else None
    else:
        init_shifts = torch.zeros((B, 2), device=dev)
        init_axes = torch.zeros((B, 3), device=dev)
        init_psi_deg = torch.zeros((B,), device=dev)
        cone = None
    if fsc_curve is not None:
        ring_cref = torch.as_tensor(
            ring_weights_from_fsc(fsc_curve, cfg.radii, cfg.n_data),
            device=dev)
    else:
        ring_cref = torch.ones(len(cfg.radii), device=dev)
    poses, scores = _frm_refine_core(
        stack, as_f32(ctf_params, dev), cfg.W_re, cfg.W_im, cfg.pts,
        cfg.ring_w, bank.FUc, bank.u2sum,
        torch.as_tensor(bank.directions, device=dev),
        torch.as_tensor(bank.axes, device=dev),
        cfg.shift_grid, cfg.coarse_shifts, init_shifts, init_axes,
        init_psi_deg, ring_cref,
        cfg.n, cfg.n_psi, cfg.pixel_size, cfg.voltage_kv, cfg.cs_mm,
        cfg.amplitude_contrast, cfg.rounds, int(d_block), cfg.upsample,
        cone, cfg.coarse_step, cfg.wiener, cfg.polar_gather)
    # internal shifts are +content offsets on the crop grid: flip to the
    # pose convention and rescale to data pixels
    poses = torch.cat([poses[:, :3], poses[:, 3:5] * (-1.0 / cfg.crop)], 1)
    return poses, scores


def _score_directions(Xp_cands, wr, FUc, u2sum, d_block: int):
    """Per-(particle, direction) best-over-(psi, shift candidate) scores
    for candidate spectra (S, B, R, P): (scores, psi_idx, s_idx), each
    (B, D) for D a multiple of d_block."""
    S, B, R, K = Xp_cands.shape
    A = Xp_cands.conj() * wr[None, :, :, None]
    FA = torch.fft.fft(A, dim=-1)                          # (S, B, R, K)
    xnorm2 = (wr[:, :, None] * _abs2(Xp_cands[0])).sum(dim=(1, 2))
    D = FUc.shape[0]
    dev = Xp_cands.device
    scores, psis, sids = [], [], []
    for d0 in range(0, D, d_block):
        fu = FUc[d0:d0 + d_block]
        u2 = u2sum[d0:d0 + d_block]
        den = torch.sqrt(torch.clamp(wr @ u2.T, min=1e-20)
                         * xnorm2[:, None])
        fr = fu.permute(2, 1, 0)                           # (K, R, d)
        best = torch.full((B, d_block), float("-inf"), device=dev)
        pidx = torch.zeros((B, d_block), dtype=torch.int64, device=dev)
        sidx = torch.zeros((B, d_block), dtype=torch.int64, device=dev)
        for s in range(S):  # running max bounds memory
            nh = torch.matmul(FA[s].permute(2, 0, 1), fr)  # (K, B, d)
            num = torch.fft.ifft(nh.permute(1, 2, 0), dim=-1).real
            sc = num / den[..., None]                      # (B, d, K)
            pi = torch.argmax(sc, dim=-1)
            val = torch.gather(sc, -1, pi[..., None])[..., 0]
            upd = val > best
            pidx = torch.where(upd, pi, pidx)
            sidx = torch.where(upd, torch.full_like(sidx, s), sidx)
            best = torch.maximum(best, val)
        scores.append(best)
        psis.append(pidx)
        sids.append(sidx)
    return torch.cat(scores, 1), torch.cat(psis, 1), torch.cat(sids, 1)


@_fp32_matmul()
def frm_score_directions(stack, ctf_params, cfg: FrmConfig, bank: FrmBank,
                         shifts=None, fsc_curve=None, d_block: int = 64,
                         marginalize_shifts: bool = False):
    """Score every particle against every bank direction (best psi each):
    (scores (B, D), psi_deg (B, D), shifts_best (B, D, 2)) — the
    soft-assignment primitive of marginalized ab initio and classification.

    shifts: known per-particle estimates (pose convention) applied before
    scoring. marginalize_shifts: also maximize each (b, d) entry over the
    config's coarse shift grid; shifts_best then holds the winning
    candidate per direction (data pixels, pose convention)."""
    dev = cfg.device
    stack = cfg.crop_stack(as_f32(stack, dev))
    B = stack.shape[0]
    D = bank.FUc.shape[0]
    Xp, wr = _restore_polar(
        stack, as_f32(ctf_params, dev), cfg.W_re, cfg.W_im, cfg.pts,
        cfg.ring_w, cfg.n, cfg.n_psi, cfg.pixel_size, cfg.voltage_kv,
        cfg.cs_mm, cfg.amplitude_contrast, cfg.wiener, cfg.polar_gather)
    if fsc_curve is not None:
        wr = wr * torch.as_tensor(
            ring_weights_from_fsc(fsc_curve, cfg.radii, cfg.n_data),
            device=dev)[None]
    # incoming shifts use the pose convention (centering translation);
    # internal candidates are +content offsets: negate at the boundary
    base = (torch.zeros((B, 2), device=dev) if shifts is None
            else -as_f32(shifts, dev) * cfg.crop)
    if marginalize_shifts:
        cand = cfg.coarse_shifts[:, None, :] + base[None]    # (S, B, 2)
    else:
        cand = base[None]                                    # (1, B, 2)
    Xp_cands = Xp[None] * shift_phasor_polar(cfg.pts, cand, cfg.n)
    d_block = min(d_block, D)
    pad = (-D) % d_block
    FUc, u2sum = bank.FUc, bank.u2sum
    if pad:
        FUc = torch.nn.functional.pad(FUc, (0, 0, 0, 0, 0, pad))
        u2sum = torch.nn.functional.pad(u2sum, (0, 0, 0, pad))
    scores, psis, sids = _score_directions(Xp_cands, wr, FUc, u2sum, d_block)
    sids = sids[:, :D]
    # winning absolute shift per (particle, direction), data pixels, pose
    # convention
    cand_bd = cand.permute(1, 0, 2)                          # (B, S, 2)
    shifts_best = -torch.gather(
        cand_bd, 1, sids[..., None].expand(B, D, 2)) / cfg.crop
    return (scores[:, :D],
            psis[:, :D].to(torch.float32) * (360.0 / cfg.n_psi),
            shifts_best)


_CFG_CACHE: dict = {}


def get_config(n, pixel_size, **kw) -> FrmConfig:
    """FrmConfig factory with caching: the polar matrix is an
    O(n^2 R n_psi) host build worth reusing across iterations with the
    same geometry. The key includes the device and the polar-sampler
    override."""
    key = (int(n), float(pixel_size),
           os.environ.get("PYP_TPU_FRM_POLAR", "auto").lower(),
           tuple(sorted((k, float(v) if isinstance(v, (int, float)) else str(v))
                        for k, v in kw.items())))
    if key not in _CFG_CACHE:
        if len(_CFG_CACHE) > 8:  # bound host and device memory
            _CFG_CACHE.clear()
        _CFG_CACHE[key] = FrmConfig(n, pixel_size, **kw)
    return _CFG_CACHE[key]


def to_refine_result(poses, scores, n_band_points: int = 1024):
    """(poses, scores) -> the RefineResult record of the table layer
    (FREALIGN-compatible SCORE/LOGP/SIGMA columns)."""
    scores = torch.clamp(scores, -1.0, 1.0)
    sigma = torch.sqrt(torch.clamp(1.0 - scores ** 2, min=1e-6))
    logp = -0.5 * n_band_points * torch.log(torch.clamp(sigma, min=1e-6))
    return RefineResult(
        phi=torch.remainder(poses[:, 0], 360.0),
        theta=torch.remainder(poses[:, 1], 360.0),
        psi=torch.remainder(poses[:, 2], 360.0),
        shift_y=poses[:, 3],
        shift_x=poses[:, 4],
        score=scores * 100.0,
        logp=logp,
        sigma=sigma,
    )
