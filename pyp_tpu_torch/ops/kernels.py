"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

`shift_scored_match`: the global-search scoring core (the port of
pyp_tpu/ops/pallas_kernels.py `shift_scored_match`): for every
(particle x psi) row and reference direction, the best CTF-weighted
correlation over S candidate shifts and the first shift that attains it,

    score[a, d] = max_s  Re( sum_g v[a, g] * E[g, s] * u[g, d] ) * ninv[a, d]

On a CUDA tensor the wrapper lays the operands out for the tensor-core
kernel in `csrc/shift_scored_match.cu` (`kernel_operands`: one real GEMM
with K = 2G, each operand split into TF32 hi and lo parts, cut into tile
images) and launches it (built by `_build` at first use) or raises; on a
CPU tensor it runs `shift_scored_match_plain`, the loop over shifts the
kernel replaces, which is also the kernel's test oracle.

`csp_slice_gather`: the CSP model gather (`ops.csp._csp_model_gather`),
the trilinear, Friedel-aware values of a padded reference spectrum at
every mask point of every rotated central slice, as one kernel forward
and one backward (`csrc/csp_slice_gather.cu`) behind a
`torch.autograd.Function`; on a CPU tensor, `csp_slice_gather_plain`,
which is `fourier_slice.slice_at_points`, the elementwise chain that the
kernel replaces (and autograd through it).

`csp_score`: CSP's CTF-weighted NCC (`ops.csp._csp_ncc`) of every row from
its shift, its defocus, its window samples and its reference slice values,
as one kernel forward and one backward (`csrc/csp_score.cu`) behind a
`torch.autograd.Function`; on a CPU tensor, `csp_score_plain`, the chain
the kernel replaces (and autograd through it). `csp_score_grad_plain` is
the backward kernel's arithmetic in PyTorch, its oracle.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from pyp_tpu_torch.core import ctf as ctf_model
from pyp_tpu_torch.ops.fourier_slice import slice_at_points, slice_points
from pyp_tpu_torch.utils.timer import span


def shift_scored_match_plain(v, u, E, ninv):
    """Plain PyTorch version: a loop over shifts of one complex matmul each,
    with a strict-`>` running max from -inf (the first best shift wins).
    v (A, G) c64, u (G, D) c64, E (G, S) c64, ninv (A, D) f32 ->
    (score (A, D) f32, sidx (A, D) int32)."""
    best = torch.full_like(ninv, float("-inf"))
    idx = torch.zeros(ninv.shape, dtype=torch.int32, device=ninv.device)
    for s in range(E.shape[1]):
        score = ((v * E[:, s][None, :]) @ u).real * ninv
        better = score > best
        best = torch.where(better, score, best)
        idx = torch.where(better, torch.full_like(idx, s), idx)
    return best, idx


# the kernel's tiling (csrc/shift_scored_match.cu): rows per tile,
# directions per tile, K per stage, most shifts per chunk; the built
# library reports its own, and `_launcher` refuses a mismatch
BM, DT, KC, SCMAX = 128, 8, 16, 32


def _launcher():
    from pyp_tpu_torch.ops import _build

    lib = _build.load("shift_scored_match")
    fn = lib.shift_scored_match_launch
    if fn.argtypes is None:
        layout = (ctypes.c_int * 4)()
        lib.shift_scored_match_layout(layout)
        if tuple(layout) != (BM, DT, KC, SCMAX):
            raise RuntimeError(
                f"shift_scored_match: the kernel reads tiles of (BM, DT, KC, "
                f"SCMAX) = {tuple(layout)}, the wrapper writes "
                f"{(BM, DT, KC, SCMAX)}")
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _cdiv(a, b):
    return -(-a // b)


def shift_chunks(S):
    """(chunks, shifts per chunk): S shifts as the fewest chunks of at most
    SCMAX, all of one size (the last padded with zero-weight shifts that
    the kernel skips)."""
    n_chunk = _cdiv(S, SCMAX)
    return n_chunk, _cdiv(S, n_chunk)


def round_tf32(x):
    """x (float32) rounded to TF32's 10 mantissa bits, ties away from zero
    (PTX cvt.rna.tf32.f32), as float32 with the low 13 bits zero."""
    bits = x.contiguous().view(torch.int32)
    return (bits + 0x1000).bitwise_and_(-0x2000).view(torch.float32)


def tf32_split_(x):
    """(hi, lo) with hi = tf32(x) and lo = x - hi, exact in float32, in
    x's storage: the 3xTF32 operand pair (the tensor cores read lo to
    TF32, so hi + lo carries x to within 2^-21 |x|)."""
    hi = round_tf32(x)
    return hi, x.sub_(hi)


def kernel_operands(v, u, E):
    """The kernel's operands as tile images, from v (A, G), u (G, D), E
    (G, S) complex64. The product is one real GEMM with K = 2G:

        num[a, (s, d)] = sum_k Ak[a, k] * Bk[(s, d), k]
        Ak = [Re v | Im v],  Bk[(s, d)] = [Re(E_s u_d); -Im(E_s u_d)]

    K is padded with zeros to a multiple of KC, rows to whole tiles,
    directions to whole tiles of DT and shifts to whole chunks. Each
    (tile, k-block) is one contiguous block in wgmma's no-swizzle K-major
    layout: core matrices of 8 rows x 4 floats, K-adjacent ones 128 bytes
    apart, 8-row groups KC*32 bytes apart. Returns (a_hi, a_lo, b_hi,
    b_lo, n_kb, n_chunk, sc):

        a_*  (n_m, n_kb, BM/8, KC/4, 8, 4)
        b_*  (n_t, n_chunk, n_kb, sc, KC/4, 8, 4)  B rows ordered (s, d)
    """
    A, G = v.shape
    D, S = u.shape[1], E.shape[1]
    n_m, n_t = _cdiv(A, BM), _cdiv(D, DT)
    n_kb = _cdiv(2 * G, KC)
    n_chunk, sc = shift_chunks(S)
    Kp = n_kb * KC
    f32 = dict(dtype=torch.float32, device=v.device)
    ak = torch.nn.functional.pad(torch.cat([v.real, v.imag], 1),
                                 (0, Kp - 2 * G, 0, n_m * BM - A))
    a = torch.empty((n_m, n_kb, BM // 8, KC // 4, 8, 4), **f32)
    a.permute(0, 2, 4, 1, 3, 5).copy_(
        ak.view(n_m, BM // 8, 8, n_kb, KC // 4, 4))
    # Bk = P Q + R T elementwise over (k, s, d), from (K, S) and (K, D)
    # factors, written straight into the tile order: Re(E u) = Er ur - Ei ui
    # for k < G, -Im(E u) = -Er ui - Ei ur for G <= k < 2G
    P, R = (torch.zeros((Kp, n_chunk * sc), **f32) for _ in range(2))
    Q, T = (torch.zeros((Kp, n_t * DT), **f32) for _ in range(2))
    P[:G, :S], P[G:2 * G, :S] = E.real, -E.real
    R[:G, :S] = R[G:2 * G, :S] = -E.imag
    Q[:G, :D], Q[G:2 * G, :D] = u.real, u.imag
    T[:G, :D], T[G:2 * G, :D] = u.imag, u.real

    def by_shift(x):  # (Kp, S') -> (1, n_chunk, n_kb, sc, KC/4, 1, 4)
        return (x.view(n_kb, KC // 4, 4, n_chunk, sc)
                .permute(3, 0, 4, 1, 2)[None, :, :, :, :, None])

    def by_direction(x):  # (Kp, D') -> (n_t, 1, n_kb, 1, KC/4, DT, 4)
        return (x.view(n_kb, KC // 4, 4, n_t, DT)
                .permute(3, 0, 1, 4, 2)[:, None, :, None])

    b = torch.empty((n_t, n_chunk, n_kb, sc, KC // 4, DT, 4), **f32)
    torch.mul(by_shift(P), by_direction(Q), out=b)
    b.addcmul_(by_shift(R), by_direction(T))
    return (*tf32_split_(a), *tf32_split_(b), n_kb, n_chunk, sc)


def shift_scored_match(v, u, E, ninv):
    """v (A, G) complex64, u (G, D) complex64, E (G, S) complex64, ninv
    (A, D) float32, all on one device -> (best score (A, D) float32, best
    shift index (A, D) int32). CUDA tensors launch the hand-written kernel
    (counted in `shift_scored_match.launches`) on operands laid out by
    `kernel_operands`; CPU tensors take the plain version."""
    A, G = v.shape
    D = u.shape[1]
    S = E.shape[1]
    if u.shape[0] != G or E.shape[0] != G or tuple(ninv.shape) != (A, D):
        raise ValueError(
            f"shift_scored_match: shapes v {tuple(v.shape)}, u "
            f"{tuple(u.shape)}, E {tuple(E.shape)}, ninv {tuple(ninv.shape)} "
            "do not agree")
    for name, t, dt in (("v", v, torch.complex64), ("u", u, torch.complex64),
                        ("E", E, torch.complex64),
                        ("ninv", ninv, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"shift_scored_match: {name} is {t.dtype}, "
                            f"expected {dt}")
        if t.device != v.device:
            raise ValueError("shift_scored_match: inputs on different devices")
    if v.device.type == "cpu":
        return shift_scored_match_plain(v, u, E, ninv)
    if v.device.type != "cuda":
        raise ValueError(f"shift_scored_match: no kernel for {v.device}")
    if G < 1 or S < 1:
        raise ValueError(f"shift_scored_match: the kernel needs G >= 1 and "
                         f"S >= 1, got G={G}, S={S}")

    with torch.cuda.device(v.device):
        return launch_kernel(kernel_operands(v, u, E), ninv, S)


def launch_kernel(operands, ninv, S):
    """Launches the CUDA kernel on `kernel_operands`' output for S shifts
    and ninv (A, D) on the current stream (counted in
    `shift_scored_match.launches`) -> (score, sidx)."""
    a_hi, a_lo, b_hi, b_lo, n_kb, n_chunk, sc = operands
    A, D = ninv.shape
    nv = ninv.contiguous()
    score = torch.empty((A, D), dtype=torch.float32, device=nv.device)
    sidx = torch.empty((A, D), dtype=torch.int32, device=nv.device)
    err = _launcher()(
        a_hi.data_ptr(), a_lo.data_ptr(), b_hi.data_ptr(), b_lo.data_ptr(),
        nv.data_ptr(), score.data_ptr(), sidx.data_ptr(), A, D, S, n_kb,
        n_chunk, sc, torch.cuda.current_stream(nv.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"shift_scored_match kernel launch failed: CUDA "
                           f"error {err}")
    shift_scored_match.launches += 1
    return score, sidx


shift_scored_match.launches = 0


# The CSP model gather's plain version: csp_slice_gather's CPU path and the
# kernel's oracle.
csp_slice_gather_plain = slice_at_points


def csp_slice_gather_grad_plain(R, mask_pts, Fref, scale, grad):
    """Plain PyTorch version of the backward kernel: the gradient (rows, 3,
    3) with respect to R (rows, 3, 3) of Re(sum conj(grad) * u) for u =
    csp_slice_gather_plain and grad (rows, G) complex, through the
    trilinear weights' derivatives, the flip's sign and the scale (the
    kernel's arithmetic, summed over G; the third row is 0)."""
    m, nxf = Fref.shape[0], Fref.shape[2]
    flat = Fref.reshape(-1)
    q = scale * slice_points(R, mask_pts)
    flip = q[..., 2] < 0
    sign = 1.0 - 2.0 * flip.to(q.dtype)
    qs = q * sign[..., None]
    k0 = torch.floor(qs)
    frac = qs - k0
    k0 = k0.to(torch.int64)
    dv = torch.zeros(q.shape, dtype=Fref.dtype, device=q.device)
    for c in range(8):
        d = (c >> 2, (c >> 1) & 1, c & 1)
        kz, ky, kx = (k0[..., i] + d[i] for i in range(3))
        v = flat[((kz % m) * m + ky % m) * nxf + kx.clamp(0, nxf - 1)]
        v = v * (kx <= nxf - 1)
        w = [frac[..., i] if d[i] else 1 - frac[..., i] for i in range(3)]
        for i in range(3):
            a = (1.0 if d[i] else -1.0) * w[(i + 1) % 3] * w[(i + 2) % 3]
            dv[..., i] += a * v
    g = torch.where(flip, grad.conj(), grad)[..., None]
    inside = torch.sum(q * q, -1) <= (m // 2) ** 2
    dq = (g.real * dv.real + g.imag * dv.imag) * (scale * sign
                                                  * inside)[..., None]
    dq = dq.flip(-1)                                        # (rows, G, 3) xyz
    return torch.stack([torch.einsum("rgc,g->rc", dq, mask_pts[:, 1]),
                        torch.einsum("rgc,g->rc", dq, mask_pts[:, 0]),
                        torch.zeros_like(dq[:, 0])], 1)


def _slice_launchers():
    from pyp_tpu_torch.ops import _build

    lib = _build.load("csp_slice_gather")
    fwd, bwd = lib.csp_slice_gather_forward, lib.csp_slice_gather_backward
    if fwd.argtypes is None:
        args = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
        fwd.argtypes = bwd.argtypes = args
        fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


class _SliceGather(torch.autograd.Function):
    """The kernel forward on R (rows, 3, 3), and the backward kernel for R's
    gradient. The forward lays each (y, x) corner quad of Fref side by side
    in Fq (m, m, nxf, 4), which the backward reads again; the corners are
    recomputed."""

    @staticmethod
    def forward(ctx, R, mask_pts, Fref, scale):
        rows, G = R.shape[0], mask_pts.shape[0]
        m, nxf = Fref.shape[0], Fref.shape[2]
        Fq = torch.empty((m, m, nxf, 4), dtype=torch.complex64,
                         device=R.device)
        out = torch.empty((rows, G), dtype=torch.complex64, device=R.device)
        err = _slice_launchers()[0](
            R.data_ptr(), mask_pts.data_ptr(), Fref.data_ptr(),
            Fq.data_ptr(), out.data_ptr(), rows, G, m, nxf, scale,
            torch.cuda.current_stream(R.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"csp_slice_gather forward launch failed: "
                               f"CUDA error {err}")
        csp_slice_gather.launches += 1
        ctx.save_for_backward(R, mask_pts, Fq)
        ctx.scale = scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        with span("csp.gather.backward"):
            R, mask_pts, Fq = ctx.saved_tensors
            if grad.dtype != torch.complex64:
                raise TypeError(f"csp_slice_gather: the output's gradient "
                                f"is {grad.dtype}, expected complex64")
            grad = grad.contiguous()
            dR = torch.empty_like(R)
            err = _slice_launchers()[1](
                R.data_ptr(), mask_pts.data_ptr(), Fq.data_ptr(),
                grad.data_ptr(), dR.data_ptr(), R.shape[0], mask_pts.shape[0],
                Fq.shape[0], Fq.shape[2], ctx.scale,
                torch.cuda.current_stream(R.device).cuda_stream)
            if err != 0:
                raise RuntimeError(f"csp_slice_gather backward launch "
                                   f"failed: CUDA error {err}")
            csp_slice_gather.backward_launches += 1
            return dR, None, None, None


def csp_slice_gather(R, mask_pts, Fref, scale):
    """R (..., 3, 3) float32 rotations, mask_pts (G, 2) float32 (ky, kx),
    Fref (m, m, m//2+1) complex64, all on one device -> (..., G) complex64:
    csp_slice_gather_plain's values, differentiable with respect to R. CUDA
    tensors launch the kernel forward (counted in
    `csp_slice_gather.launches`) and, for R's gradient, the backward kernel
    (`csp_slice_gather.backward_launches`); CPU tensors take the plain
    version and autograd through it. The kernel takes only R's gradient:
    mask points or an Fref that require grad are refused."""
    if mask_pts.device != R.device or Fref.device != R.device:
        raise ValueError("csp_slice_gather: inputs on different devices")
    if R.device.type == "cpu":
        return csp_slice_gather_plain(R, mask_pts, Fref, scale)
    if R.device.type != "cuda":
        raise ValueError(f"csp_slice_gather: no kernel for {R.device}")
    for name, t, dt in (("R", R, torch.float32),
                        ("mask_pts", mask_pts, torch.float32),
                        ("Fref", Fref, torch.complex64)):
        if t.dtype != dt:
            raise TypeError(f"csp_slice_gather: {name} is {t.dtype}, "
                            f"expected {dt}")
    m = Fref.shape[0]
    if (tuple(R.shape[-2:]) != (3, 3) or mask_pts.dim() != 2
            or mask_pts.shape[1] != 2 or Fref.dim() != 3
            or tuple(Fref.shape) != (m, m, m // 2 + 1)):
        raise ValueError(
            f"csp_slice_gather: shapes R {tuple(R.shape)}, mask_pts "
            f"{tuple(mask_pts.shape)}, Fref {tuple(Fref.shape)}; expected "
            "(..., 3, 3), (G, 2), (m, m, m//2+1)")
    for name, t in (("mask_pts", mask_pts), ("Fref", Fref)):
        if not t.is_contiguous() or t.data_ptr() % 8:
            raise ValueError(f"csp_slice_gather: {name} must be contiguous "
                             "and 8-byte aligned")
        if t.requires_grad:
            raise ValueError(f"csp_slice_gather: {name} requires grad; the "
                             "kernel gives R's gradient only")
    lead, G = R.shape[:-2], mask_pts.shape[0]
    R3 = R.reshape(-1, 3, 3).contiguous()
    with torch.cuda.device(R.device):
        out = _SliceGather.apply(R3, mask_pts, Fref, float(scale))
    return out.view(lead + (G,))


csp_slice_gather.launches = 0
csp_slice_gather.backward_launches = 0


def csp_score_plain(dshift, df, xv, u, mask_pts, n, pixel_size, voltage_kv,
                    cs_mm, amplitude_contrast):
    """Plain PyTorch version: dshift (..., 2) (dy, dx), df (...) Å, xv and
    u (..., G) complex, mask_pts (G, 2) (ky, kx), the leading axes
    broadcast -> the CTF-weighted NCC (...): the CTF at df
    (`refine3d._ctf_at_points` with df1 = df2), the phase of the shift,
    and num / sqrt(sum |x|^2 * sum c^2 |u|^2 + 1e-12) over G."""
    from pyp_tpu_torch.ops.refine3d import _ctf_at_points

    c = _ctf_at_points(mask_pts, n, pixel_size, df[..., None], df[..., None],
                       0.0, voltage_kv, cs_mm, amplitude_contrast, 0.0)
    # model window = projection whose content sits at +dshift from the
    # window center: M = u exp(-2 pi i g.dshift / n); num = Re<X, M>
    ph = (-2.0 * math.pi / n) * (mask_pts[:, 0] * dshift[..., 0:1]
                                 + mask_pts[:, 1] * dshift[..., 1:2])
    xr, xi, ur, ui = xv.real, xv.imag, u.real, u.imag
    re_xu = xr * ur + xi * ui          # Re(conj(x) u)
    im_xu = xr * ui - xi * ur          # Im(conj(x) u)
    num = torch.sum(c * (re_xu * torch.cos(ph) - im_xu * torch.sin(ph)), -1)
    den = torch.sqrt(torch.sum(xr * xr + xi * xi, -1)
                     * torch.sum(c * c * (ur * ur + ui * ui), -1) + 1e-12)
    return num / den


def csp_score_grad_plain(dshift, df, xv, u, mask_pts, n, pixel_size,
                         voltage_kv, cs_mm, amplitude_contrast, grad):
    """Plain PyTorch version of the backward kernel: the gradients (d
    dshift, d df, d u) of sum(grad * csp_score_plain(...)) for grad of the
    broadcast leading shape, each summed to its input's shape, in closed
    form: with ncc = num / D, D = sqrt(X U + 1e-12), gA = grad / D and gU =
    -grad ncc X / (2 D^2) are the gradients of num and U = sum c^2 |u|^2;
    per point d num / d ph = -c Re(conj(x) u e^{i ph} i), d num / d c = Re(
    conj(x) u e^{i ph}), d c / d df = -cos(chi + amp) pi lam |g|^2, and
    d u = gA c x e^{-i ph} + 2 gU c^2 u (dL/dRe u + i dL/dIm u)."""
    gy = mask_pts[:, 0] / (n * pixel_size)
    gx = mask_pts[:, 1] / (n * pixel_size)
    g = torch.sqrt(gy * gy + gx * gx)
    lam = ctf_model.wavelength(voltage_kv)
    arg = (ctf_model.chi(g, df[..., None], voltage_kv, cs_mm)
           + math.atan2(amplitude_contrast,
                        math.sqrt(max(1.0 - amplitude_contrast ** 2, 0.0))))
    c = -torch.sin(arg)
    dc_ddf = -torch.cos(arg) * (math.pi * lam * g * g)
    k = -2.0 * math.pi / n
    ph = k * (mask_pts[:, 0] * dshift[..., 0:1] + mask_pts[:, 1] * dshift[..., 1:2])
    cp, sp = torch.cos(ph), torch.sin(ph)
    xr, xi, ur, ui = xv.real, xv.imag, u.real, u.imag
    re, im = xr * ur + xi * ui, xr * ui - xi * ur
    u2 = ur * ur + ui * ui
    num = torch.sum(c * (re * cp - im * sp), -1)
    X = torch.sum(xr * xr + xi * xi, -1)
    U = torch.sum(c * c * u2, -1)
    q = X * U + 1e-12
    D = torch.sqrt(q)
    gA = (grad / D)[..., None]
    gU = (-0.5 * grad * (num / D) * (X / q))[..., None]
    dnum_dph = -c * (re * sp + im * cp)
    d_shift = gA[..., 0, None] * torch.stack(
        [torch.sum(dnum_dph * (k * mask_pts[:, 0]), -1),
         torch.sum(dnum_dph * (k * mask_pts[:, 1]), -1)], -1)
    d_df = torch.sum((gA * (re * cp - im * sp) + 2.0 * gU * c * u2) * dc_ddf,
                     -1)
    du = (gA * c * torch.complex(xr * cp + xi * sp, xi * cp - xr * sp)
          + 2.0 * gU * c * c * u)
    return (d_shift.sum_to_size(dshift.shape), d_df.sum_to_size(df.shape),
            du.sum_to_size(u.shape))


def _score_launchers():
    from pyp_tpu_torch.ops import _build

    lib = _build.load("csp_score")
    fwd, bwd = lib.csp_score_forward, lib.csp_score_backward
    if fwd.argtypes is None:
        head = ([ctypes.c_void_p, ctypes.c_longlong] * 4
                + [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong]
                + [ctypes.c_float] * 4)
        fwd.argtypes = head + [ctypes.c_void_p] * 3
        bwd.argtypes = head + [ctypes.c_void_p] * 6
        fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


@functools.lru_cache(maxsize=64)
def _score_consts(n, pixel_size, voltage_kv, cs_mm, amplitude_contrast):
    """The kernel's four numbers: -2 pi / n, chi's factors of |k|^2 df and
    |k|^4 (at the chain's float32 wavelength), and the amplitude
    contrast's phase."""
    lam = float(ctf_model.wavelength(voltage_kv))
    npix2 = float(n * pixel_size) ** 2
    w = amplitude_contrast
    return (-2.0 * math.pi / n, math.pi * lam / npix2,
            0.5 * math.pi * cs_mm * 1e7 * lam ** 3 / npix2 ** 2,
            math.atan2(w, math.sqrt(max(1.0 - w * w, 0.0))))


class _CspScore(torch.autograd.Function):
    """The kernel forward on rows of dshift (rows_s, 2), df (rows_d,), xv
    (rows_x, G) and u (rows_u, G), each read at row r mod its count, for
    `rows` rows; the backward kernel for the gradients of dshift, df and,
    where it requires grad, u, each summed to its own rows. The forward
    saves each row's three sums for the backward."""

    @staticmethod
    def forward(ctx, dshift, df, xv, u, mask_pts, rows, consts):
        dev = dshift.device
        ncc = torch.empty(rows, dtype=torch.float32, device=dev)
        sums = torch.empty((rows, 3), dtype=torch.float32, device=dev)
        err = _score_launchers()[0](
            *_score_args(dshift, df, xv, u, mask_pts, rows, consts),
            ncc.data_ptr(), sums.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"csp_score forward launch failed: CUDA "
                               f"error {err}")
        csp_score.launches += 1
        ctx.save_for_backward(dshift, df, xv, u, mask_pts, sums)
        ctx.rows, ctx.consts = rows, consts
        return ncc

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        dshift, df, xv, u, mask_pts, sums = ctx.saved_tensors
        rows, dev = ctx.rows, dshift.device
        if grad.dtype != torch.float32:
            raise TypeError(f"csp_score: the output's gradient is "
                            f"{grad.dtype}, expected float32")
        grad = grad.contiguous()
        d_shift = torch.empty((rows, 2), dtype=torch.float32, device=dev)
        d_df = torch.empty(rows, dtype=torch.float32, device=dev)
        du = (torch.empty((rows, u.shape[1]), dtype=torch.complex64,
                          device=dev) if ctx.needs_input_grad[3] else None)
        err = _score_launchers()[1](
            *_score_args(dshift, df, xv, u, mask_pts, rows, ctx.consts),
            sums.data_ptr(), grad.data_ptr(), d_shift.data_ptr(),
            d_df.data_ptr(), du.data_ptr() if du is not None else None,
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"csp_score backward launch failed: CUDA "
                               f"error {err}")
        csp_score.backward_launches += 1

        def own_rows(d, x):   # summed over the rows that read x's row again
            return d if x.shape[0] == rows else d.view(
                (rows // x.shape[0],) + x.shape).sum(0)

        return (own_rows(d_shift, dshift) if ctx.needs_input_grad[0] else None,
                own_rows(d_df, df) if ctx.needs_input_grad[1] else None,
                None, own_rows(du, u) if du is not None else None,
                None, None, None)


def _score_args(dshift, df, xv, u, mask_pts, rows, consts):
    return (dshift.data_ptr(), dshift.shape[0], df.data_ptr(), df.shape[0],
            xv.data_ptr(), xv.shape[0], u.data_ptr(), u.shape[0],
            mask_pts.data_ptr(), mask_pts.shape[0], rows, *consts)


def _broadcast(*shapes):
    """The shape the leading shapes broadcast to (torch.broadcast_shapes,
    whose first call imports the symbolic-shape machinery, seconds of a
    process's start)."""
    out = []
    for i in range(-max(map(len, shapes)), 0):
        sizes = {s[i] for s in shapes if len(s) >= -i} - {1}
        if len(sizes) > 1:
            raise ValueError(f"csp_score: leading shapes "
                             f"{[tuple(s) for s in shapes]} do not broadcast")
        out.append(sizes.pop() if sizes else 1)
    return torch.Size(out)


def _as_rows(x, lead, tail):
    """x (..., *tail) as contiguous rows (r, *tail) that row i of the
    leading shape `lead` reads at i mod r: x's leading shape, less any
    leading 1s, is a suffix of `lead` (the grid search's candidate axis
    leads), else x is expanded to `lead`."""
    xl = tuple(x.shape[:x.dim() - len(tail)])
    while xl and xl[0] == 1:
        xl = xl[1:]
    if xl != tuple(lead[len(lead) - len(xl):]):
        x, xl = x.expand(tuple(lead) + tuple(tail)), lead
    return x.reshape((math.prod(xl),) + tuple(tail)).contiguous()


def csp_score(dshift, df, xv, u, mask_pts, n: int, pixel_size: float,
              voltage_kv: float, cs_mm: float, amplitude_contrast: float):
    """dshift (..., 2) float32 (dy, dx), df (...) float32 Å, xv and u (...,
    G) complex64, mask_pts (G, 2) float32 (ky, kx), all on one device, the
    leading axes broadcast -> the CTF-weighted NCC (...) float32 of
    csp_score_plain, differentiable with respect to dshift, df and u. CUDA
    tensors launch the kernel forward (counted in `csp_score.launches`)
    and, for the gradients, the backward kernel
    (`csp_score.backward_launches`); CPU tensors take the plain version
    and autograd through it. Window samples xv or mask points that require
    grad are refused: the kernel gives no gradient for them."""
    for name, t, dt in (("dshift", dshift, torch.float32),
                        ("df", df, torch.float32),
                        ("xv", xv, torch.complex64),
                        ("u", u, torch.complex64),
                        ("mask_pts", mask_pts, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"csp_score: {name} is {t.dtype}, expected {dt}")
        if t.device != dshift.device:
            raise ValueError("csp_score: inputs on different devices")
    G = mask_pts.shape[0] if mask_pts.dim() == 2 else -1
    if (mask_pts.dim() != 2 or mask_pts.shape[1] != 2 or dshift.dim() < 1
            or dshift.shape[-1] != 2 or xv.dim() < 1 or xv.shape[-1] != G
            or u.dim() < 1 or u.shape[-1] != G):
        raise ValueError(
            f"csp_score: shapes dshift {tuple(dshift.shape)}, xv "
            f"{tuple(xv.shape)}, u {tuple(u.shape)}, mask_pts "
            f"{tuple(mask_pts.shape)}; expected (..., 2), (..., G), (..., G), "
            "(G, 2)")
    lead = _broadcast(dshift.shape[:-1], df.shape, xv.shape[:-1],
                      u.shape[:-1])
    for name, t in (("xv", xv), ("mask_pts", mask_pts)):
        if t.requires_grad:
            raise ValueError(f"csp_score: {name} requires grad; the kernel "
                             "gives no gradient for it")
    if dshift.device.type == "cpu":
        return csp_score_plain(dshift, df, xv, u, mask_pts, n, pixel_size,
                               voltage_kv, cs_mm, amplitude_contrast)
    if dshift.device.type != "cuda":
        raise ValueError(f"csp_score: no kernel for {dshift.device}")
    rows = math.prod(lead)
    consts = _score_consts(int(n), float(pixel_size), float(voltage_kv),
                           float(cs_mm), float(amplitude_contrast))
    mask_pts = mask_pts.contiguous()
    if mask_pts.data_ptr() % 8:     # the kernel reads a point as a float2
        mask_pts = mask_pts.clone()
    with torch.cuda.device(dshift.device):
        out = _CspScore.apply(
            _as_rows(dshift, lead, (2,)), _as_rows(df, lead, ()),
            _as_rows(xv, lead, (G,)), _as_rows(u, lead, (G,)),
            mask_pts, rows, consts)
    return out.view(lead)


csp_score.launches = 0
csp_score.backward_launches = 0
