"""Legacy subvolume averaging (StA) — the torch port of pyp_tpu/ops/sva.py,
the reference's sva* entry points: align extracted subvolumes to a
reference and average them. The production subtomogram path is CSPT
(pipeline/csp.py).

The reference is rotated once per candidate angle (a bank shared by every
subvolume), the translational search is an FFT cross-correlation for all
subvolume x angle pairs, and the average back-rotates each subvolume with
one trilinear resample while accumulating rotated missing-wedge masks for
the per-frequency wedge compensation (the 3DAVG wedge-normalized average).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pyp_tpu_torch import as_f32, resolve_device
from pyp_tpu_torch.ops.template_match import rotate_volume


class SvaResult(NamedTuple):
    angles: torch.Tensor   # (B, 3) ZYZ degrees (reference -> subvolume)
    shifts: torch.Tensor   # (B, 3) voxels (z, y, x)
    scores: torch.Tensor   # (B,) normalized correlation
    average: torch.Tensor  # (n, n, n) wedge-compensated aligned average


def wedge_mask(n: int, half_angle_deg: float):
    """Binary missing-wedge mask on the fftshifted full Fourier grid:
    |kz| <= tan(half_angle) * |kx| passes (tilt axis = y, beam = z)."""
    if half_angle_deg >= 90.0:
        return np.ones((n, n, n), dtype=np.float32)
    ax = np.fft.fftshift(np.fft.fftfreq(n))
    kz = ax[:, None, None]
    kx = ax[None, None, :]
    t = np.tan(np.deg2rad(half_angle_deg))
    m = (np.abs(kz) <= t * np.abs(kx) + 1e-9).astype(np.float32)
    return np.broadcast_to(m, (n, n, n)).copy()  # (z, y, x) full grid


def _sphere(n: int, frac: float = 0.45, radius_px: float = 0.0,
            sigma_px: float = 0.0):
    """Spherical alignment mask (reference sva mask/mask_sigma): hard
    radius (default 0.45n) with an optional soft cosine edge."""
    ax = np.arange(n) - n // 2
    r = np.sqrt(ax[:, None, None] ** 2 + ax[None, :, None] ** 2
                + ax[None, None, :] ** 2)
    rad = radius_px if radius_px > 0 else frac * n
    if sigma_px <= 0:
        return (r <= rad).astype(np.float32)
    t = np.clip((r - rad) / sigma_px, 0.0, 1.0)
    return (0.5 * (1 + np.cos(np.pi * t))).astype(np.float32)


def _band_filter(n: int, lowpass=(0.25, 0.05), highpass=(0.0, 0.0)):
    """Radial band weight on the rfftn grid; cutoffs/decays in 0..1 of
    Nyquist with cosine rolloffs (the reference's sva convention)."""
    fz = np.fft.fftfreq(n)[:, None, None]
    fy = np.fft.fftfreq(n)[None, :, None]
    fx = np.fft.rfftfreq(n)[None, None, :]
    f = np.sqrt(fz * fz + fy * fy + fx * fx) / 0.5  # 0..1 at Nyquist
    w = np.ones_like(f, dtype=np.float32)
    lc, ld = (float(lowpass[0]), float(max(lowpass[1], 1e-4)))
    if 0 < lc < 1:
        t = np.clip((f - lc) / ld, 0.0, 1.0)
        w *= 0.5 * (1 + np.cos(np.pi * t))
    hc, hd = (float(highpass[0]), float(max(highpass[1], 1e-4)))
    if hc > 0:
        t = np.clip((hc - f) / hd, 0.0, 1.0)
        w *= 0.5 * (1 + np.cos(np.pi * t))
    return w.astype(np.float32)


def _local_grid(tol_angle: float, step: float):
    """Rotations within `tol_angle` degrees of the identity: directions on
    the cap theta <= tol plus in-plane psi in [-tol, tol], ZYZ degrees."""
    out = [(0.0, 0.0, 0.0)]
    psis = np.arange(-tol_angle, tol_angle + 1e-6, max(step, 1.0))
    thetas = np.arange(step, tol_angle + 1e-6, max(step, 1.0))
    for p in psis:
        if abs(p) > 1e-6:
            out.append((0.0, 0.0, float(p)))
    for t in thetas:
        n_phi = max(1, int(round(360.0 * np.sin(np.deg2rad(t)) / step)))
        for phi in np.arange(0.0, 360.0, 360.0 / n_phi):
            for p in psis:
                # phi rotates the tilt axis; -phi brings it back so the
                # net rotation stays within the cap
                out.append((float(phi), float(t), float(p - phi)))
    return np.asarray(out, dtype=np.float32)


def _score_block(SubF, bank, sub_norm, extent: int):
    """cc of every (subvolume, bank angle) pair over the shift window.

    SubF: (B, n, n, nf) rfftn of subvolumes; bank: (A, n, n, n) rotated
    zero-mean unit-norm references. Returns (best_cc (B,), a_idx (B,),
    shift (B, 3)) for this bank block; ties go to the first angle and the
    first shift, as argmax takes them."""
    n = bank.shape[-1]
    dev = SubF.device
    BankF = torch.fft.rfftn(bank, dim=(-3, -2, -1))
    # shift window (wraparound indexing: keep |shift| <= extent)
    ax = torch.arange(n, device=dev)
    d = torch.minimum(ax, n - ax)
    win = ((d[:, None, None] <= extent) & (d[None, :, None] <= extent)
           & (d[None, None, :] <= extent))
    vals, idxs = [], []
    for a in range(bank.shape[0]):
        cc = torch.fft.irfftn(SubF * torch.conj(BankF[a])[None],
                              s=(n, n, n), dim=(-3, -2, -1))
        cc = torch.where(win[None], cc, -torch.inf)
        flat = cc.reshape(cc.shape[0], -1)
        idx = torch.argmax(flat, dim=-1)
        vals.append(torch.gather(flat, 1, idx[:, None])[:, 0])
        idxs.append(idx)
    vals, idxs = torch.stack(vals), torch.stack(idxs)
    a_best = torch.argmax(vals, dim=0)                       # (B,)
    cc_best = torch.gather(vals, 0, a_best[None])[0]
    flat_best = torch.gather(idxs, 0, a_best[None])[0]
    z = flat_best // (n * n)
    y = (flat_best // n) % n
    x = flat_best % n
    shift = torch.stack([torch.where(v > n // 2, v - n, v) for v in (z, y, x)],
                        -1).to(torch.float32)
    return cc_best / torch.clamp(sub_norm, min=1e-6), a_best, shift


def align_subvolumes(subvols, reference, angular_step: float = 30.0,
                     symmetry: str = "C1", shift_extent: int = 8,
                     wedge_deg: float = 90.0, angle_block: int = 16,
                     lowpass=(0.25, 0.05), highpass=(0.0, 0.0),
                     mask_rad: float = 0.0, mask_sigma: float = 0.0,
                     grid=None, device="cuda"):
    """One alignment pass on `device`: best (ZYZ angle, integer shift) per
    subvolume over the global grid (make_directions x psi at the same
    step) or an explicit (A, 3) `grid`, band-limited by the radial
    lowpass/highpass and scored against the soft-masked reference.
    Returns (angles (B, 3), shifts (B, 3), scores (B,)) tensors."""
    from pyp_tpu_torch.ops.refine3d import make_directions

    dev = resolve_device(device)
    subvols = as_f32(subvols, dev)
    B, n = subvols.shape[0], subvols.shape[-1]
    if grid is None:
        dirs = np.asarray(make_directions(angular_step, symmetry))
        psis = np.arange(0.0, 360.0, angular_step, dtype=np.float32)
        grid = np.array([(d[0], d[1], p) for d in dirs for p in psis],
                        dtype=np.float32)                    # (A, 3)
    grid = np.asarray(grid, dtype=np.float32)
    sph = as_f32(_sphere(n, radius_px=mask_rad, sigma_px=mask_sigma), dev)
    band = as_f32(_band_filter(n, lowpass, highpass), dev)
    ref = as_f32(reference, dev)
    ref = (ref - torch.mean(ref)) * sph
    # the band filter is isotropic, so it commutes with the bank rotations
    ref = torch.fft.irfftn(torch.fft.rfftn(ref) * band, s=(n, n, n))
    wedge = None
    if wedge_deg < 90.0:
        wedge = as_f32(np.fft.ifftshift(wedge_mask(n, wedge_deg))
                       [..., : n // 2 + 1], dev)
    sub = subvols - torch.mean(subvols, dim=(-3, -2, -1), keepdim=True)
    SubF = torch.fft.rfftn(sub, dim=(-3, -2, -1)) * band[None]
    subf = torch.fft.irfftn(SubF, s=(n, n, n), dim=(-3, -2, -1))
    sub_norm = torch.sqrt(torch.sum(subf * subf, dim=(-3, -2, -1)))

    best_cc = torch.full((B,), -torch.inf, device=dev)
    best_a = torch.zeros((B,), dtype=torch.int64, device=dev)
    best_s = torch.zeros((B, 3), device=dev)
    for lo in range(0, len(grid), angle_block):
        bank = []
        for phi, theta, psi in grid[lo:lo + angle_block]:
            r = rotate_volume(ref, float(phi), float(theta), float(psi))
            if wedge is not None:
                # compare inside the subvolume's wedge support only
                r = torch.fft.irfftn(torch.fft.rfftn(r) * wedge, s=(n, n, n))
            r = r - torch.mean(r)
            bank.append(r / torch.clamp(torch.sqrt(torch.sum(r * r)),
                                        min=1e-6))
        cc, a_idx, shift = _score_block(SubF, torch.stack(bank), sub_norm,
                                        int(shift_extent))
        better = cc > best_cc
        best_cc = torch.where(better, cc, best_cc)
        best_a = torch.where(better, a_idx + lo, best_a)
        best_s = torch.where(better[:, None], shift, best_s)
    return as_f32(grid, dev)[best_a], best_s, best_cc


def _roll_back(v, shift):
    """Roll a volume by minus its rounded (z, y, x) shift."""
    return torch.roll(v, tuple(-int(round(float(s))) for s in shift),
                      (0, 1, 2))


def refine_subvolumes(subvols, reference, prev_angles, prev_shifts,
                      tol_angle: float, step: float, device="cuda", **kw):
    """Local refinement around known poses on `device`: each subvolume is
    pre-shifted and back-rotated by its current pose, a small rotation grid
    within `tol_angle` of the identity is searched, and the result composes
    with the prior pose. Returns (angles, shifts, scores) in the original
    frame."""
    from pyp_tpu_torch.core.geometry import euler_to_matrix, matrix_to_euler

    dev = resolve_device(device)
    subvols = as_f32(subvols, dev)
    prev_angles = np.asarray(prev_angles, dtype=np.float64)
    prev_shifts = np.asarray(prev_shifts, dtype=np.float64)
    B = len(subvols)
    pre = torch.stack([
        rotate_volume(_roll_back(subvols[b], prev_shifts[b]),
                      -float(prev_angles[b, 2]), -float(prev_angles[b, 1]),
                      -float(prev_angles[b, 0]))
        for b in range(B)])
    d_ang, d_shift, scores = align_subvolumes(
        pre, reference, grid=_local_grid(tol_angle, step), device=dev, **kw)
    d_ang = d_ang.cpu().numpy().astype(np.float64)
    d_shift = d_shift.cpu().numpy().astype(np.float64)
    out_ang = np.zeros((B, 3), np.float32)
    out_shift = np.zeros((B, 3), np.float32)

    def mat(a):   # float32 rotation, as the JAX package computes it
        return euler_to_matrix(*(torch.tensor(float(v)) for v in a)).numpy(
        ).astype(np.float64)

    for b in range(B):
        Rp = mat(prev_angles[b])
        Rc = torch.as_tensor((Rp @ mat(d_ang[b])).astype(np.float32))
        out_ang[b] = np.asarray([float(v) for v in matrix_to_euler(Rc)])
        # the shift composes through the prior rotation (shifts are
        # (z, y, x); R acts on xyz column vectors)
        out_shift[b] = prev_shifts[b] + (Rp @ d_shift[b][::-1])[::-1]
    return as_f32(out_ang, dev), as_f32(out_shift, dev), scores


def center_subvolumes(subvols, iters: int = 2, shift_extent: int = 8,
                      wedge_deg: float = 90.0, device="cuda", **kw):
    """Translation-only pre-centering against the running average (the
    reference's sva centering mode 0). Returns (shifts (B, 3) numpy,
    centered average tensor)."""
    dev = resolve_device(device)
    subvols = as_f32(subvols, dev)
    B = len(subvols)
    shifts = np.zeros((B, 3), np.float32)
    ref = subvols.mean(0)
    ident = np.zeros((1, 3), np.float32)
    for _ in range(max(1, int(iters))):
        _, s, _ = align_subvolumes(subvols, ref, grid=ident,
                                   shift_extent=shift_extent,
                                   wedge_deg=wedge_deg, device=dev, **kw)
        shifts = s.cpu().numpy().astype(np.float32)
        ref = average_subvolumes(subvols, np.zeros((B, 3)), shifts,
                                 wedge_deg=wedge_deg, device=dev)
    return shifts, ref


def classify_subvolumes(subvols, angles, shifts, n_classes: int,
                        wedge_deg: float = 90.0, lowpass_frac: float = 0.3,
                        seed: int = 0, iters: int = 12, device="cuda"):
    """Aligned-frame k-means classification (the reference's sva
    classification): back-transform every subvolume into the reference
    frame on `device`, lowpass, k-means on the host (k-means++ seeding from
    `seed`), and return (labels, per-class wedge-compensated averages)."""
    dev = resolve_device(device)
    subvols = as_f32(subvols, dev)
    angles = np.asarray(angles)
    shifts = np.asarray(shifts)
    B, n = subvols.shape[0], subvols.shape[-1]
    band = as_f32(_band_filter(n, (lowpass_frac, 0.05)), dev)
    feats = []
    for b in range(B):
        vr = rotate_volume(_roll_back(subvols[b], shifts[b]),
                           -float(angles[b, 2]), -float(angles[b, 1]),
                           -float(angles[b, 0]))
        f = torch.fft.irfftn(torch.fft.rfftn(vr) * band,
                             s=(n, n, n)).cpu().numpy().astype(np.float32)
        f = (f - f.mean()) / (f.std() + 1e-6)
        feats.append(f.ravel())
    X = np.stack(feats)
    rng = np.random.RandomState(seed)
    K = max(1, int(n_classes))
    centers = [X[rng.randint(B)]]
    for _ in range(1, K):
        d2 = np.min([np.sum((X - c) ** 2, axis=1) for c in centers], axis=0)
        p = d2 / max(d2.sum(), 1e-9)
        centers.append(X[rng.choice(B, p=p)])
    C = np.stack(centers)
    labels = np.zeros(B, np.int32)
    for _ in range(int(iters)):
        d = ((X[:, None] - C[None]) ** 2).sum(-1)
        labels = np.argmin(d, axis=1).astype(np.int32)
        for k in range(K):
            if np.any(labels == k):
                C[k] = X[labels == k].mean(axis=0)
    class_avgs = []
    for k in range(K):
        sel = labels == k
        if not np.any(sel):
            class_avgs.append(torch.zeros((n, n, n), device=dev))
            continue
        idx = torch.as_tensor(np.nonzero(sel)[0], device=dev)
        class_avgs.append(average_subvolumes(
            subvols[idx], angles[sel], shifts[sel], wedge_deg=wedge_deg,
            device=dev))
    return labels, class_avgs


def average_subvolumes(subvols, angles, shifts, wedge_deg: float = 90.0,
                       score_weights=None, device="cuda"):
    """Wedge-compensated aligned average on `device`: each subvolume is
    shifted, rotated into the reference frame (inverse ZYZ), and
    accumulated in Fourier space with its rotated wedge mask; each Fourier
    coefficient is divided by its wedge coverage (the 3DAVG
    normalization)."""
    dev = resolve_device(device)
    subvols = as_f32(subvols, dev)
    angles = np.asarray(angles)
    shifts = np.asarray(shifts)
    B, n = subvols.shape[0], subvols.shape[-1]
    wm = as_f32(wedge_mask(n, wedge_deg), dev)  # fftshifted layout, centre n//2
    num = torch.zeros((n, n, n), dtype=torch.complex64, device=dev)
    den = torch.zeros((n, n, n), device=dev)
    w = (np.ones(B, np.float32) if score_weights is None
         else np.asarray(score_weights, np.float32))
    for b in range(B):
        phi, theta, psi = (float(v) for v in angles[b])
        # inverse of R(phi, theta, psi) in ZYZ is R(-psi, -theta, -phi);
        # the rotated volume's wedge support is the rotated mask
        vr = rotate_volume(_roll_back(subvols[b], shifts[b]), -psi, -theta,
                           -phi)
        mr = torch.fft.ifftshift(rotate_volume(wm, -psi, -theta, -phi))
        num = num + float(w[b]) * torch.fft.fftn(vr) * mr
        den = den + float(w[b]) * mr
    avg = torch.fft.ifftn(num / torch.clamp(den, min=float(0.05 * den.max())))
    return avg.real


def sva_iterate(subvols, reference=None, iters: int = 3,
                angular_step: float = 30.0, symmetry: str = "C1",
                shift_extent: int = 8, wedge_deg: float = 90.0,
                refine_factor: float = 0.5,
                lowpass=(0.25, 0.05), highpass=(0.0, 0.0),
                mask_rad: float = 0.0, mask_sigma: float = 0.0,
                centering_iters: int = 0, keep_fraction: float = 1.0,
                local_refine: bool = True, device="cuda") -> SvaResult:
    """Full legacy loop on `device`: (optional translation pre-centering)
    -> global align -> wedge-average -> local refinement rounds at halving
    angular steps. keep_fraction drops the worst-scoring tail from each
    average; reference=None seeds from the raw unaligned average."""
    dev = resolve_device(device)
    subvols = as_f32(subvols, dev)
    band_kw = dict(lowpass=lowpass, highpass=highpass,
                   mask_rad=mask_rad, mask_sigma=mask_sigma)
    if centering_iters > 0 and reference is None:
        _, ref = center_subvolumes(subvols, iters=centering_iters,
                                   shift_extent=shift_extent,
                                   wedge_deg=wedge_deg, device=dev, **band_kw)
    else:
        ref = (subvols.mean(0) if reference is None
               else as_f32(reference, dev))

    def weights(sc):
        sc = sc.cpu().numpy()
        w = np.clip(sc, 0.0, None)
        if keep_fraction < 1.0:
            cut = np.percentile(sc, 100.0 * (1.0 - keep_fraction))
            w = np.where(sc >= cut, w, 0.0)
        return w

    step = float(angular_step)
    prev_step = step
    angles = shifts = scores = None
    for it in range(max(1, int(iters))):
        if it == 0 or not local_refine:
            angles, shifts, scores = align_subvolumes(
                subvols, ref, angular_step=step, symmetry=symmetry,
                shift_extent=shift_extent, wedge_deg=wedge_deg, device=dev,
                **band_kw)
            prev_step = step
        else:
            step = max(step * refine_factor, 7.5)
            angles, shifts, scores = refine_subvolumes(
                subvols, ref, angles.cpu().numpy(), shifts.cpu().numpy(),
                tol_angle=prev_step, step=step,
                shift_extent=max(2, shift_extent // 2),
                wedge_deg=wedge_deg, device=dev, **band_kw)
            prev_step = step
        ref = average_subvolumes(
            subvols, angles.cpu().numpy(), shifts.cpu().numpy(),
            wedge_deg=wedge_deg, score_weights=weights(scores), device=dev)
        if not local_refine:
            step = max(step * refine_factor, 7.5)
    return SvaResult(angles=angles, shifts=shifts, scores=scores, average=ref)
