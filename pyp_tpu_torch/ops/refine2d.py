"""2D classification / alignment — the torch port of pyp_tpu/ops/refine2d.py.

Iterative multi-reference alignment:

  E-step (engine="polar", default): the ops/frm machinery. Particles are
  CTF-Wiener-restored and polar-transformed once per classification,
  class averages become polar tables by two matmuls per iteration, and all
  (class, psi, shift) scores come from FFT correlation along the ring
  angle. engine="gather": the particle spectrum sampled at psi-rotated
  band-limited points, scored against every class at every shift by
  `ops.kernels.shift_scored_match` (the hand-written CUDA kernel on a
  card, its plain version on the CPU).

  M-step: best-aligned particles are shifted and rotated in real space
  and accumulated into CTF-weighted class sums (`index_add_`):
      avg_k = sum_i w_ik CTF_i X_i / (sum_i w_ik CTF_i^2 + wiener)

Every entry point runs on `device` (default "cuda"; raises without a
card). Host randomness is `np.random.RandomState(seed)` in the JAX code's
order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pyp_tpu_torch import as_f32, resolve_device, rows_per_call
from pyp_tpu_torch.ops import frm
from pyp_tpu_torch.ops.fourier_slice import (
    fourier_to_image,
    gather_2d_hermitian,
    image_to_fourier,
)
from pyp_tpu_torch.ops.kernels import shift_scored_match
from pyp_tpu_torch.ops.reconstruct import _ctf_grids, _shift_correct
from pyp_tpu_torch.ops.refine3d import (
    _abs2,
    _ctf_at_points,
    _rotate_points_2d,
    _shift_phasors,
    make_mask_points,
    make_shift_grid,
)


class Classify2DResult(NamedTuple):
    class_avgs: torch.Tensor    # (K, n, n)
    assignments: torch.Tensor   # (B,) int
    psi: torch.Tensor           # (B,) degrees
    shift_y: torch.Tensor       # (B,) pixels
    shift_x: torch.Tensor
    scores: torch.Tensor        # (B,)
    occupancy: torch.Tensor     # (K,) particles per class


def _bilinear_constant(imgs, ys, xs):
    """`map_coordinates(order=1, mode="constant")` of each image (B, n, n)
    at its own coordinates (B, ...): four taps, each out-of-range tap zero
    on its own."""
    B, ny, nx = imgs.shape
    flat = imgs.reshape(B, -1)
    y0f, x0f = torch.floor(ys), torch.floor(xs)
    fy, fx = ys - y0f, xs - x0f
    y0, x0 = y0f.to(torch.int64), x0f.to(torch.int64)
    out = None
    for dy in (0, 1):
        for dx in (0, 1):
            iy, ix = y0 + dy, x0 + dx
            w = (fy if dy else 1.0 - fy) * (fx if dx else 1.0 - fx)
            ok = (iy >= 0) & (iy < ny) & (ix >= 0) & (ix < nx)
            lin = (torch.clamp(iy, 0, ny - 1) * nx
                   + torch.clamp(ix, 0, nx - 1)).reshape(B, -1)
            v = torch.gather(flat, 1, lin).reshape(ys.shape)
            term = torch.where(ok, v, 0.0) * w
            out = term if out is None else out + term
    return out


def _rotate_images(imgs, psi_deg):
    """Rotate images (B, n, n) by psi (degrees, per image, about the
    centre pixel n//2) with bilinear interpolation, zero outside. Positive
    psi matches the projection convention (a particle aligned at psi is
    rotated by -psi to match the reference)."""
    n = imgs.shape[-1]
    c = n // 2
    ax = torch.arange(n, dtype=torch.float32, device=imgs.device) - c
    yy, xx = torch.meshgrid(ax, ax, indexing="ij")
    a = torch.deg2rad(as_f32(psi_deg, imgs.device))
    co, si = torch.cos(a)[:, None, None], torch.sin(a)[:, None, None]
    xs = co * xx - si * yy + c
    ys = si * xx + co * yy + c
    return _bilinear_constant(imgs.to(torch.float32), ys, xs)


def align_to_classes(
    stack, ctf_params, class_avgs, psis, mask_pts, shift_grid,
    n: int, pixel_size: float,
    voltage_kv: float = 300.0, cs_mm: float = 2.7,
    amplitude_contrast: float = 0.07,
):
    """Gather E-step: best (class, psi, shift) per particle, all tensors on
    one device. For every (particle, psi) row the best score over (class,
    shift) is

        max_{k,s} Re(sum_g v[a,g] E[g,s] u[g,k]) / (cnorm[a,k] xnorm[a])

    with v = conj(X(rot_pts)) CTF, u the class spectra and E the shift
    phasors: the `shift_scored_match` contraction, run in particle chunks
    sized from the free device memory, then an argmax over k. Ties between
    different (k, s) may resolve differently from the JAX scan (first s
    then first k there; first s per k, then first k here).

    Returns (assignment (B,), psi (B,), shifts (B, 2), score (B,))."""
    B = stack.shape[0]
    P = psis.shape[0]
    G = mask_pts.shape[0]
    K = class_avgs.shape[0]
    img_pad = 2
    dev = stack.device

    Favg = image_to_fourier(class_avgs)                       # (K, n, nxf)
    u = gather_2d_hermitian(Favg, mask_pts)                   # (K, G)
    u2 = _abs2(u)
    uT = u.T.contiguous()
    rot_pts = _rotate_points_2d(mask_pts[None], psis[:, None])  # (P, G, 2)
    E = _shift_phasors(mask_pts, shift_grid, n)               # (G, S)

    scores, ks, ss = [], [], []
    # per particle: the pad-2 spectrum, the (psi x point) samples, CTF and
    # operands, and the kernel's tile images of its P rows
    step = rows_per_call(dev, B, 16 * (2 * n) * (n + 1) + 64 * P * G
                         + 16 * P * K)
    for lo in range(0, B, step):
        X = image_to_fourier(stack[lo:lo + step], pad=img_pad)
        b = X.shape[0]
        xv = gather_2d_hermitian(X, rot_pts, scale=float(img_pad))  # (b, P, G)
        del X
        cp = ctf_params[lo:lo + step, :, None, None]
        c = _ctf_at_points(rot_pts[None], n, pixel_size, cp[:, 0], cp[:, 1],
                           cp[:, 2], voltage_kv, cs_mm, amplitude_contrast,
                           cp[:, 3])                          # (b, P, G)
        v = (xv.conj() * c).reshape(b * P, G)
        c2 = (c * c).reshape(b * P, G)
        xnorm = torch.sqrt(_abs2(xv).reshape(b * P, G).sum(dim=1) + 1e-12)
        del xv, c
        cnorm = torch.sqrt(c2 @ u2.T + 1e-12)                 # (bP, K)
        best_ks, sidx_ks = shift_scored_match(
            v, uT, E, 1.0 / (cnorm * xnorm[:, None]))
        k = torch.argmax(best_ks, dim=1)
        scores.append(torch.gather(best_ks, 1, k[:, None])[:, 0])
        ks.append(k)
        ss.append(torch.gather(sidx_ks, 1, k[:, None])[:, 0].to(torch.int64))
    score_bp = torch.cat(scores).reshape(B, P)
    k_bp, s_bp = torch.cat(ks), torch.cat(ss)

    psi_idx = torch.argmax(score_bp, dim=1)
    best_score = torch.gather(score_bp, 1, psi_idx[:, None])[:, 0]
    flat = psi_idx + torch.arange(B, device=dev) * P
    k_best = k_bp[flat]
    s_best = s_bp[flat]
    psi = psis[psi_idx]
    s_rot = shift_grid[s_best]
    a = torch.deg2rad(psi)
    co, si = torch.cos(a), torch.sin(a)
    sx = co * s_rot[:, 1] - si * s_rot[:, 0]
    sy = si * s_rot[:, 1] + co * s_rot[:, 0]
    return k_best, psi, torch.stack([sy, sx], 1), best_score


class Polar2D:
    """Cached polar-matching tables for 2D classification (the 2D analogue
    of ops/frm: exact-kernel polar resampling by matmul and psi-FFT
    correlation), on one device. The cache key includes the device."""

    _CACHE: dict = {}

    def __init__(self, n, pixel_size, low_res, high_res, shift_extent,
                 shift_step, voltage_kv, cs_mm, amplitude_contrast,
                 wiener: float = 0.1, device="cuda"):
        dev = self.device = resolve_device(device)
        self.n = int(n)
        self.pixel_size = float(pixel_size)
        self.radii = frm.make_rings(n, pixel_size, low_res, high_res)
        self.n_psi = frm.default_n_psi(self.radii)
        self.ring_w = torch.as_tensor(frm.ring_weights(self.radii), device=dev)
        W_re, W_im = frm.polar_matrix(n, self.radii, self.n_psi)
        self.W_re = torch.as_tensor(W_re, device=dev)
        self.W_im = torch.as_tensor(W_im, device=dev)
        self.pts = torch.as_tensor(frm.polar_points(self.radii, self.n_psi),
                                   device=dev)
        self.coarse_step = max(float(shift_step), float(shift_extent) / 3.0)
        self.coarse_shifts = torch.as_tensor(
            make_shift_grid(shift_extent, self.coarse_step), device=dev)
        self.fine_shifts = torch.as_tensor(
            make_shift_grid(self.coarse_step, float(shift_step)), device=dev)
        self.voltage_kv = float(voltage_kv)
        self.cs_mm = float(cs_mm)
        self.amplitude_contrast = float(amplitude_contrast)
        self.wiener = float(wiener)

    @classmethod
    def get(cls, *key, device="cuda"):
        dev = resolve_device(device)
        full = key + (str(dev),)
        if full not in cls._CACHE:
            if len(cls._CACHE) > 8:
                cls._CACHE.clear()
            cls._CACHE[full] = cls(*key, device=dev)
        return cls._CACHE[full]

    @frm._fp32_matmul()
    def restore(self, stack, ctf_params):
        """Wiener CTF-restored polar spectra and ring weights, computed
        once per classification (particles do not change between
        iterations, class averages do)."""
        return frm._restore_polar(
            as_f32(stack, self.device), as_f32(ctf_params, self.device),
            self.W_re, self.W_im, self.pts, self.ring_w, self.n, self.n_psi,
            self.pixel_size, self.voltage_kv, self.cs_mm,
            self.amplitude_contrast, self.wiener)


def _class_polar_tables(class_avgs, W_re, W_im, n_rings: int):
    """Polar tables of the (CTF-free) class averages: Up, FUc for the psi
    correlation, and per-ring power sums."""
    K = class_avgs.shape[0]
    Xa = frm.image_to_fourier_full(class_avgs)
    Up = frm._polar_matmul(Xa.real.reshape(K, -1), Xa.imag.reshape(K, -1),
                           W_re, W_im).reshape(K, n_rings, -1)
    FUc = torch.fft.fft(Up.conj(), dim=-1).conj()
    u2sum = frm._abs2(Up).sum(dim=-1)
    return Up, FUc, u2sum


@frm._fp32_matmul()
def align_to_classes_polar(Xp, wr, class_avgs, p2d: Polar2D):
    """E-step on the polar machinery: all (class, psi, shift) at once.

    Xp/wr from Polar2D.restore (particle side, computed once per
    classification). Returns (assignment, psi_deg, shifts (B, 2), score)
    in the conventions of align_to_classes."""
    B = Xp.shape[0]
    Up, FUc, u2sum = _class_polar_tables(
        as_f32(class_avgs, p2d.device), p2d.W_re, p2d.W_im, len(p2d.radii))
    K = Up.shape[0]
    # coarse shift marginalization (the scheme of frm's round 0), all
    # classes in one block
    cand = p2d.coarse_shifts[:, None, :].expand(-1, B, 2)
    phas = frm.shift_phasor_polar(p2d.pts, cand, p2d.n)
    scores, s_idx, k_idx, psi_idx = frm._match(
        Xp[None] * phas, wr, FUc, u2sum,
        torch.zeros((B, K), device=Xp.device), K, 4)
    rows = torch.arange(B, device=Xp.device)
    shifts = cand[s_idx, rows]
    psi_deg = psi_idx.to(torch.float32) * (360.0 / (p2d.n_psi * 4))
    # fine shift grid around the coarse winner
    shifts, scores = frm._refine_shifts(
        Xp, wr, Up[k_idx], u2sum[k_idx], psi_deg, p2d.pts,
        p2d.fine_shifts[None] + shifts[:, None, :], p2d.n)
    # frm's shift is the content displacement; the M-step's _shift_correct
    # expects the correction to apply, i.e. its negation
    return k_idx, psi_deg, -shifts, scores


def update_class_averages(
    stack, ctf_params, assignments, psi, shifts, weights,
    n: int, n_classes: int, pixel_size: float,
    voltage_kv: float = 300.0, cs_mm: float = 2.7,
    amplitude_contrast: float = 0.07, wiener: float = 10.0,
):
    """M-step (merge2d): CTF-weighted class sums from aligned particles
    (tensors on one device). Each particle is shifted by its recorded
    shift, then resampled in the class frame: class(y) =
    particle_shifted(Rz(psi) y)."""
    X = _shift_correct(image_to_fourier(stack), shifts, n)
    aligned = _rotate_images(fourier_to_image(X, n), psi)
    Xa = image_to_fourier(aligned)
    ctfs = _ctf_grids(n, pixel_size, ctf_params, voltage_kv, cs_mm,
                      amplitude_contrast)
    wc = weights[:, None, None] * ctfs
    idx = assignments.to(torch.int64)
    num = torch.zeros((n_classes,) + Xa.shape[1:], dtype=Xa.dtype,
                      device=Xa.device).index_add_(0, idx, wc * Xa)
    den = torch.zeros((n_classes,) + Xa.shape[1:], dtype=torch.float32,
                      device=Xa.device).index_add_(0, idx, wc * ctfs)
    avgs = fourier_to_image(num / (den + wiener), n)
    occ = torch.zeros(n_classes, device=Xa.device).index_add_(
        0, idx, weights.to(torch.float32))
    return avgs, occ


def classify2d(
    stack, ctf_params, n_classes: int, pixel_size: float,
    iters: int = 10, psi_step: float = 15.0,
    low_res: float = 100.0, high_res: float = 10.0,
    shift_extent: float = 5.0, shift_step: float = 2.0,
    voltage_kv: float = 300.0, cs_mm: float = 2.7,
    amplitude_contrast: float = 0.07, seed: int = 0,
    engine: str = "polar", wiener: float = 10.0,
    init_avgs=None, device="cuda",
) -> Classify2DResult:
    """Full 2D classification on `device`: random init, then alternating
    E and M steps.

    init_avgs: warm-start class averages (K, n, n); skips the random
    seeding (the staged protocol's later phases).

    engine="polar" (default) runs the E-step on the polar machinery;
    engine="gather" scores per-(particle, psi) spectrum samples through
    shift_scored_match."""
    dev = resolve_device(device)
    stack = as_f32(stack, dev)
    ctf_params = as_f32(ctf_params, dev)
    B, n, _ = stack.shape
    rng = np.random.RandomState(seed)
    weights = torch.ones(B, device=dev)
    if init_avgs is not None:
        avgs = as_f32(init_avgs, dev)
        init_assign = torch.zeros(B, dtype=torch.int64, device=dev)
    else:
        # seed each class from a small disjoint random subset (a symmetric
        # init would make all averages identical)
        perm = rng.permutation(B)
        seeds_per_class = max(1, min(3, B // n_classes))
        init_np = np.full(B, -1, dtype=np.int64)
        for k in range(n_classes):
            init_np[perm[k * seeds_per_class:(k + 1) * seeds_per_class]] = k
        seed_mask = init_np >= 0
        init_assign = torch.as_tensor(np.maximum(init_np, 0), device=dev)
        avgs, occ = update_class_averages(
            stack, ctf_params, init_assign, torch.zeros(B, device=dev),
            torch.zeros((B, 2), device=dev),
            as_f32(seed_mask.astype(np.float32), dev), n, n_classes,
            pixel_size, voltage_kv, cs_mm, amplitude_contrast, wiener=wiener)
    psis = as_f32(np.arange(0.0, 360.0, psi_step, dtype=np.float32), dev)
    mask_pts = as_f32(make_mask_points(n, pixel_size, low_res, high_res), dev)
    shift_grid = as_f32(make_shift_grid(shift_extent, shift_step), dev)

    assign = init_assign
    psi = torch.zeros(B, device=dev)
    shifts = torch.zeros((B, 2), device=dev)
    scores = torch.zeros(B, device=dev)
    if engine == "polar":
        p2d = Polar2D.get(n, pixel_size, low_res, high_res, shift_extent,
                          shift_step, voltage_kv, cs_mm, amplitude_contrast,
                          device=dev)
        Xp, wr = p2d.restore(stack, ctf_params)
    for _ in range(iters):
        if engine == "polar":
            assign, psi, shifts, scores = align_to_classes_polar(
                Xp, wr, avgs, p2d)
        else:
            assign, psi, shifts, scores = align_to_classes(
                stack, ctf_params, avgs, psis, mask_pts, shift_grid, n,
                pixel_size, voltage_kv, cs_mm, amplitude_contrast)
        avgs, occ = update_class_averages(
            stack, ctf_params, assign, psi, shifts, weights, n, n_classes,
            pixel_size, voltage_kv, cs_mm, amplitude_contrast, wiener=wiener)
    return Classify2DResult(
        class_avgs=avgs, assignments=assign, psi=psi,
        shift_y=shifts[:, 0], shift_x=shifts[:, 1], scores=scores,
        occupancy=occ)


def classify2d_staged(
    stack, ctf_params, params: dict, pixel_size: float,
    voltage_kv: float = 300.0, cs_mm: float = 2.7,
    amplitude_contrast: float = 0.07, device="cuda",
) -> Classify2DResult:
    """The reference's staged class2d protocol ([tabs.class2d]): three EM
    phases over growing particle subsets (ab initio on up to
    class2d_max_ab_initio particles at class2d_rhini, seeded on up to
    class2d_max_seeded at the intermediate band, refinement on up to
    class2d_max_refinement at class_rhcls), each warm-started from the
    previous phase's averages. class2d_fraction caps each phase's random
    subset; class2d_box / class2d_bin classify on a Fourier-cropped grid;
    class2d_rad masks the particles (Å). Where the last phase saw a
    subset, one more E-step assigns every particle."""
    from pyp_tpu_torch.core.fft import fourier_crop
    from pyp_tpu_torch.core.filters import soft_circular_mask

    dev = resolve_device(device)
    stack_t = as_f32(stack, dev)
    ctf_np = np.asarray(ctf_params, dtype=np.float32)
    B, n_full, _ = stack_t.shape
    n_classes = int(params.get("class_num") or 20)
    rhini = float(params.get("class2d_rhini") or 40.0)
    rhref = float(params.get("class_rhcls") or 8.0)
    rlref = float(params.get("class_rlcls") or 100.0)
    frac = float(params.get("class2d_fraction") or 1.0)
    seed = int(params.get("class_seed") or 0)
    rng = np.random.RandomState(seed)

    box = int(params.get("class2d_box") or 0)
    binf = int(params.get("class2d_bin") or 1)
    n_work = n_full
    if box and box < n_full:
        n_work = box
    elif binf > 1:
        n_work = max(32, n_full // binf)
    n_work -= n_work % 2
    if n_work < n_full:
        work_stack = fourier_crop(stack_t, (n_work, n_work))
        pixel_work = pixel_size * n_full / n_work
    else:
        work_stack, pixel_work = stack_t, pixel_size

    rad = float(params.get("class2d_rad") or 0.0)
    if rad > 0:
        m = soft_circular_mask(n_work, rad / pixel_work, 4.0, device=dev)
        work_stack = work_stack * m[None]

    common = dict(
        low_res=rlref,
        psi_step=float(params.get("class_psi_step") or 15.0),
        shift_extent=float(params.get("class_shift") or 5.0),
        shift_step=float(params.get("class_shift_step") or 2.0),
        voltage_kv=voltage_kv, cs_mm=cs_mm,
        amplitude_contrast=amplitude_contrast, seed=seed,
        engine=str(params.get("class_engine") or "polar"),
        wiener=float(params.get("class_wiener") or 10.0), device=dev)
    stages = (
        (int(params.get("class2d_max_ab_initio") or 10000),
         int(params.get("class2d_iters_init") or 15), rhini),
        (int(params.get("class2d_max_seeded") or 50000),
         int(params.get("class2d_iters_seed") or 10),
         0.5 * (rhini + rhref)),
        (int(params.get("class2d_max_refinement") or 100000),
         int(params.get("class2d_iters_refine") or 3), rhref),
    )
    avgs = None
    res = None
    for cap, iters, band in stages:
        n_use = min(B, cap, max(n_classes * 2, int(round(B * frac))))
        idx = (np.arange(B) if n_use >= B
               else rng.choice(B, size=n_use, replace=False))
        i_t = torch.as_tensor(idx, device=dev)
        res = classify2d(
            work_stack[i_t], ctf_np[idx], n_classes, pixel_work, iters=iters,
            high_res=max(band, 2.5 * pixel_work), init_avgs=avgs, **common)
        avgs = res.class_avgs
    if len(res.assignments) != B:
        res = classify2d(
            work_stack, ctf_np, n_classes, pixel_work, iters=1,
            high_res=max(rhref, 2.5 * pixel_work), init_avgs=avgs, **common)
    return res
