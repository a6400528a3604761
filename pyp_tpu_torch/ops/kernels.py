"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

`shift_scored_match`: the global-search scoring core (the port of
pyp_tpu/ops/pallas_kernels.py `shift_scored_match`): for every
(particle x psi) row and reference direction, the best CTF-weighted
correlation over S candidate shifts and the first shift that attains it,

    score[a, d] = max_s  Re( sum_g v[a, g] * E[g, s] * u[g, d] ) * ninv[a, d]

On a CUDA tensor the wrapper launches the kernel in
`csrc/shift_scored_match.cu` (built by `_build` at first use) or raises; on
a CPU tensor it runs `shift_scored_match_plain`, the loop over shifts the
kernel replaces, which is also the kernel's test oracle.
"""

from __future__ import annotations

import ctypes

import torch


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


def _launcher():
    from pyp_tpu_torch.ops import _build

    lib = _build.load("shift_scored_match")
    fn = lib.shift_scored_match_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _planes(z):
    return z.real.contiguous(), z.imag.contiguous()


def shift_scored_match(v, u, E, ninv):
    """v (A, G) complex64, u (G, D) complex64, E (G, S) complex64, ninv
    (A, D) float32, all on one device -> (best score (A, D) float32, best
    shift index (A, D) int32). CUDA tensors launch the hand-written kernel
    (counted in `shift_scored_match.launches`); CPU tensors take the plain
    version."""
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

    fn = _launcher()
    with torch.cuda.device(v.device):
        vr, vi = _planes(v)
        ur, ui = _planes(u)
        er, ei = _planes(E.T)
        nv = ninv.contiguous()
        score = torch.empty((A, D), dtype=torch.float32, device=v.device)
        sidx = torch.empty((A, D), dtype=torch.int32, device=v.device)
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = fn(vr.data_ptr(), vi.data_ptr(), ur.data_ptr(), ui.data_ptr(),
                 er.data_ptr(), ei.data_ptr(), nv.data_ptr(),
                 score.data_ptr(), sidx.data_ptr(), A, G, D, S, stream)
    if err != 0:
        raise RuntimeError(f"shift_scored_match kernel launch failed: CUDA "
                           f"error {err}")
    shift_scored_match.launches += 1
    return score, sidx


shift_scored_match.launches = 0
