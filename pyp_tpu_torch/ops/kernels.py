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
the elementwise chain through `fourier_slice.gather_3d_hermitian` that
the kernel replaces (and autograd through it).
"""

from __future__ import annotations

import ctypes

import torch

from pyp_tpu_torch.ops.fourier_slice import gather_3d_hermitian
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


def csp_slice_gather_plain(R, mask_pts, Fref, scale):
    """Plain PyTorch version: R (..., 3, 3) rotations, mask_pts (G, 2) (ky,
    kx), Fref (m, m, m//2+1) complex -> (..., G) complex, the values of Fref
    at the slice points q = kx R[0] + ky R[1], read (qz, qy, qx), times
    `scale` (gather_3d_hermitian's rules)."""
    q = (mask_pts[:, 1, None] * R[..., None, 0, :]
         + mask_pts[:, 0, None] * R[..., None, 1, :])       # (..., G, 3)
    return gather_3d_hermitian(Fref, q.flip(-1), scale=scale)


def csp_slice_gather_grad_plain(R, mask_pts, Fref, scale, grad):
    """Plain PyTorch version of the backward kernel: the gradient (rows, 3,
    3) with respect to R (rows, 3, 3) of Re(sum conj(grad) * u) for u =
    csp_slice_gather_plain and grad (rows, G) complex, through the
    trilinear weights' derivatives, the flip's sign and the scale (the
    kernel's arithmetic, summed over G; the third row is 0)."""
    m, nxf = Fref.shape[0], Fref.shape[2]
    flat = Fref.reshape(-1)
    q = scale * (mask_pts[:, 1, None] * R[:, None, 0, :]
                 + mask_pts[:, 0, None] * R[:, None, 1, :]).flip(-1)
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
