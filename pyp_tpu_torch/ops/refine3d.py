"""Projection-matching 3D refinement (the gather engine) — the torch port
of pyp_tpu/ops/refine3d.py.

  * global search: reference projections are sliced once per search
    direction at band-limited mask points; in-plane psi is handled by
    sampling the particle spectrum at rotated mask points; shifts are scored
    with separable phasors. The (particle x psi) x direction x shift score
    reduces to the `shift_scored_match` contraction, which on CUDA runs as
    the hand-written kernel in csrc/shift_scored_match.cu;
  * local refinement: the score is differentiable in (phi, theta, psi, sy,
    sx) through the trilinear gather's weights, so poses are polished by a
    few gradient-ascent steps (torch.autograd.grad of the batch-summed
    score; each particle's score depends only on its own pose);
  * scoring is FREALIGN-style CTF-weighted normalized cross-correlation in
    an annulus, with optional per-shell SSNR weights.

Public functions keep the JAX layouts: rfft half-spectra, (phi, theta, psi,
sy, sx) poses in degrees and pixels, ZYZ Euler angles.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from pyp_tpu_torch import resolve_device
from pyp_tpu_torch.core import ctf as ctf_model
from pyp_tpu_torch.core.geometry import apply_symmetry_matrices, euler_to_matrix
from pyp_tpu_torch.ops.fourier_slice import (
    gather_2d_hermitian,
    gather_3d_hermitian,
    image_to_fourier,
    volume_to_fourier,
)
from pyp_tpu_torch.ops.kernels import shift_scored_match


class RefineResult(NamedTuple):
    phi: torch.Tensor
    theta: torch.Tensor
    psi: torch.Tensor
    shift_y: torch.Tensor   # pixels
    shift_x: torch.Tensor
    score: torch.Tensor     # FREALIGN-style score (NCC * 100)
    logp: torch.Tensor
    sigma: torch.Tensor


# ---------------------------------------------------------------------------
# search geometry (host-side constants)
# ---------------------------------------------------------------------------

def make_directions(angular_step_deg: float, symmetry: str = "C1") -> np.ndarray:
    """(D, 2) array of (phi, theta) projection directions covering the
    asymmetric unit of `symmetry` quasi-uniformly."""
    thetas = np.arange(0.0, 180.0 + 1e-6, angular_step_deg)
    dirs = []
    for t in thetas:
        st = np.sin(np.radians(max(t, 1e-3)))
        n_phi = max(1, int(round(360.0 * st / angular_step_deg)))
        if t < 1e-6 or t > 180 - 1e-6:
            n_phi = 1
        for p in np.arange(n_phi) * (360.0 / n_phi):
            dirs.append((p, t))
    dirs = np.asarray(dirs, dtype=np.float32)
    sym_mats = apply_symmetry_matrices(symmetry)
    if len(sym_mats) == 1:
        return dirs
    # keep directions whose viewing axis is the canonical representative of
    # its symmetry orbit (lexicographic max of rotated z-axes)
    keep = []
    for phi, theta in dirs:
        R = euler_to_matrix(float(phi), float(theta), 0.0).numpy()
        v = R[2, :]  # viewing axis in volume frame
        orbit = np.einsum("sij,j->si", sym_mats, v)
        key = np.round(orbit @ np.array([1.0, 1e3, 1e6]), 4)
        if np.argmax(key) == 0:
            keep.append((phi, theta))
    return np.asarray(keep, dtype=np.float32)


def make_mask_points(n: int, pixel_size: float, low_res: float, high_res: float) -> np.ndarray:
    """(G, 2) integer wavenumber points (ky, kx) of the rfft half-plane inside
    the resolution annulus."""
    ky = (np.fft.fftfreq(n) * n).astype(np.float32)
    kx = np.arange(n // 2 + 1, dtype=np.float32)
    gy, gx = np.meshgrid(ky, kx, indexing="ij")
    g = np.sqrt(gy**2 + gx**2) / (n * pixel_size)  # 1/Å
    sel = (g > 1.0 / low_res) & (g < 1.0 / high_res) & (g < 0.5 / pixel_size)
    # drop the redundant kx==0, ky<0 half-line (Friedel duplicate)
    sel &= ~((gx == 0) & (gy < 0))
    pts = np.stack([gy[sel], gx[sel]], axis=-1)
    return pts.astype(np.float32)


def make_shift_grid(extent_px: float, step_px: float) -> np.ndarray:
    """(S, 2) disk of candidate shifts (rotation-invariant so the rotated
    frame trick is exact)."""
    r = np.arange(-extent_px, extent_px + 1e-6, step_px)
    sy, sx = np.meshgrid(r, r, indexing="ij")
    sel = sy**2 + sx**2 <= extent_px**2 + 1e-6
    return np.stack([sy[sel], sx[sel]], axis=-1).astype(np.float32)


def shell_weights_from_fsc(fsc_curve, mask_pts, n: int):
    """Per-frequency-point scoring weights from a half-map FSC curve: the
    Cref figure of merit sqrt(2C/(1+C)) at each mask point's |g|."""
    curve = np.clip(np.asarray(fsc_curve, dtype=np.float64), 0.0, 1.0)
    n_bins = len(curve)
    r = np.sqrt((np.asarray(mask_pts) ** 2).sum(axis=1)) / n  # cycles/px
    idx = np.clip((r / 0.5 * n_bins).astype(int), 0, n_bins - 1)
    cref = np.sqrt(2.0 * curve / (1.0 + curve))
    return cref[idx].astype(np.float32)


def focus_mask_2d(poses, focus, n: int, pixel_size: float,
                  edge_px: float = 4.0):
    """Per-particle soft 2D masks selecting the projection of a focus
    sphere. focus = (x, y, z, radius) in Å relative to the box center in
    volume coordinates; the sphere center projects through each particle's
    pose and the particle's centering shift moves the content by -shift.
    Returns (B, n, n) masks in [0, 1] with a cosine-soft edge."""
    poses = torch.as_tensor(poses, dtype=torch.float32)
    fx, fy, fz, fr = (float(v) for v in focus)
    R = euler_to_matrix(poses[:, 0], poses[:, 1], poses[:, 2])
    p = torch.tensor([fx, fy, fz], dtype=torch.float32,
                     device=poses.device) / pixel_size
    c = R @ p                       # (B, 3) image coords (x, y, z) in px
    cx = c[:, 0] - poses[:, 4]
    cy = c[:, 1] - poses[:, 3]
    ax = torch.arange(n, dtype=torch.float32, device=poses.device) - n // 2
    d2 = ((ax[None, :, None] - cy[:, None, None]) ** 2
          + (ax[None, None, :] - cx[:, None, None]) ** 2)
    t = (torch.sqrt(d2) - fr / pixel_size) / max(edge_px, 1e-3)
    return 1.0 - torch.clamp(t, 0.0, 1.0)


def parse_focus_mask(value) -> tuple | None:
    """class_focusmask string "x,y,z,r" (or colon-separated) -> tuple of
    floats, None when empty/zero-radius."""
    s = str(value or "").strip()
    if not s:
        return None
    parts = [float(v) for v in s.replace(":", ",").split(",")]
    if len(parts) != 4 or parts[3] <= 0:
        return None
    return tuple(parts)


def _rotate_points_2d(pts, psi_deg):
    """Rotate (ky, kx) points by Rz(psi): output point = Rz(psi) @ p.
    psi broadcasts against the points' leading axes."""
    a = torch.deg2rad(torch.as_tensor(psi_deg, dtype=torch.float32,
                                      device=pts.device))
    c, s = torch.cos(a), torch.sin(a)
    ky, kx = pts[..., 0], pts[..., 1]
    kx2 = c * kx - s * ky
    ky2 = s * kx + c * ky
    return torch.stack([ky2, kx2], dim=-1)


def _ctf_at_points(pts, n, pixel_size, df1, df2, angast, voltage_kv, cs_mm, w, phase):
    """Evaluate the CTF at wavenumber points (..., 2) = (ky, kx); the CTF
    parameters broadcast against the points' leading axes."""
    gy = pts[..., 0] / (n * pixel_size)
    gx = pts[..., 1] / (n * pixel_size)
    g = torch.sqrt(gy * gy + gx * gx)
    azim = torch.atan2(gy, gx)
    df = ctf_model.defocus_at_azimuth(df1, df2, angast, azim)
    x = ctf_model.chi(g, df, voltage_kv, cs_mm, phase)
    amp = math.atan2(w, math.sqrt(max(1.0 - w * w, 0.0)))
    return -torch.sin(x + amp)


def _shift_phasors(pts, shifts, n):
    """exp(+2*pi*i (g . s) / n): (G, S) for points (G, 2) and shifts (S, 2)."""
    dot = pts[:, 0:1] * shifts[None, :, 0] + pts[:, 1:2] * shifts[None, :, 1]
    ph = 2.0 * np.pi * dot / n
    return torch.complex(torch.cos(ph), torch.sin(ph))


def _abs2(z):
    return z.real * z.real + z.imag * z.imag


# ---------------------------------------------------------------------------
# global search
# ---------------------------------------------------------------------------

def global_search(
    stack,
    ctf_params,          # (B, 4): df1, df2, angast_deg, phase_shift
    Fref,                # (pn, pn, pn/2+1) centered reference spectrum
    directions,          # (D, 2) phi, theta
    psis,                # (P,) in-plane angles
    mask_pts,            # (G, 2) wavenumber points
    shift_grid,          # (S, 2) candidate shifts (pixels)
    n: int,
    pixel_size: float,
    voltage_kv: float = 300.0,
    cs_mm: float = 2.7,
    amplitude_contrast: float = 0.07,
    topk: int = 4,
):
    """Exhaustive orientation/shift search on one device (all tensors on
    Fref's device). Returns (poses (B, K, 5), scores (B, K)) of the top-K
    candidates by in-plane angle, each pose = (phi, theta, psi, sy, sx).
    The best score over shifts runs through `shift_scored_match`: the CUDA
    kernel on a GPU, its plain version on the CPU."""
    B = stack.shape[0]
    D = directions.shape[0]
    P = psis.shape[0]
    G = mask_pts.shape[0]
    vol_pad = Fref.shape[0] // n
    img_pad = 2  # oversample particle spectra so psi-rotated gathers are accurate

    X = image_to_fourier(stack, pad=img_pad)  # (B, img_pad*n, ...)

    # --- reference side: slice each direction at the mask points ---------
    Rd = euler_to_matrix(directions[:, 0], directions[:, 1],
                         torch.zeros_like(directions[:, 0]))
    ex = Rd[:, 0, :]
    ey = Rd[:, 1, :]
    q = (mask_pts[None, :, 1, None] * ex[:, None, :]
         + mask_pts[None, :, 0, None] * ey[:, None, :])  # (D, G, 3) xyz
    u = gather_3d_hermitian(Fref, q.flip(-1), scale=float(vol_pad))  # (D, G)
    u2 = _abs2(u)

    # --- particle side: gather at psi-rotated points ---------------------
    rot_pts = _rotate_points_2d(mask_pts[None], psis[:, None])  # (P, G, 2)
    xv = gather_2d_hermitian(X, rot_pts, scale=float(img_pad))  # (B, P, G)
    cp = ctf_params[:, :, None, None]                           # (B, 4, 1, 1)
    c = _ctf_at_points(rot_pts[None], n, pixel_size, cp[:, 0], cp[:, 1],
                       cp[:, 2], voltage_kv, cs_mm, amplitude_contrast,
                       cp[:, 3])                                # (B, P, G)
    v = (xv.conj() * c).reshape(B * P, G)
    c2 = (c * c).reshape(B * P, G)
    xnorm = torch.sqrt(_abs2(xv).reshape(B * P, G).sum(dim=1) + 1e-12)

    cnorm = torch.sqrt(c2 @ u2.T + 1e-12)  # (BP, D)
    E = _shift_phasors(mask_pts, shift_grid, n)  # (G, S)
    ninv = 1.0 / (cnorm * xnorm[:, None])
    best_ds, sidx_ds = shift_scored_match(v, u.T, E, ninv)
    d_bp = torch.argmax(best_ds, dim=1)                       # (BP,)
    score_bp = torch.gather(best_ds, 1, d_bp[:, None])[:, 0]
    s_bp = torch.gather(sidx_ds, 1, d_bp[:, None])[:, 0].to(torch.int64)

    score_bp = score_bp.reshape(B, P)
    k = min(topk, P)
    top_scores, psi_idx = torch.topk(score_bp, k, dim=1)    # (B, K)
    flat = psi_idx + torch.arange(B, device=psi_idx.device)[:, None] * P
    d_best = d_bp[flat]
    s_best = s_bp[flat]

    phi = directions[d_best, 0]
    theta = directions[d_best, 1]
    psi = psis[psi_idx]
    s_rot = shift_grid[s_best]  # (B, K, 2) shift in the rotated frame
    # rotate back to image frame: s = Rz(psi) s'
    a = torch.deg2rad(psi)
    c, s = torch.cos(a), torch.sin(a)
    sx = c * s_rot[..., 1] - s * s_rot[..., 0]
    sy = s * s_rot[..., 1] + c * s_rot[..., 0]
    pose = torch.stack([phi, theta, psi, sy, sx], dim=-1)  # (B, K, 5)
    return pose, top_scores


# ---------------------------------------------------------------------------
# local (continuous) refinement
# ---------------------------------------------------------------------------

def local_refine(
    stack,
    ctf_params,
    Fref,
    poses,               # (B, 5) initial (phi, theta, psi, sy, sx)
    mask_pts,
    n: int,
    pixel_size: float,
    voltage_kv: float = 300.0,
    cs_mm: float = 2.7,
    amplitude_contrast: float = 0.07,
    iters: int = 24,
    lr_angles: float = 2.0,
    lr_shifts: float = 0.4,
    weights=None,
    pose_mask=(1.0, 1.0, 1.0, 1.0, 1.0),
):
    """Gradient-ascent pose polishing over a batch of particles. Angles in
    degrees, shifts in pixels; per-parameter step sizes with cosine decay,
    per-particle normalized gradients and 0.7 momentum; the final pose is
    kept only where it scores at least the initial one.

    The particle-side samples and the CTF are pose-invariant, so they are
    computed once; each step re-gathers only the reference slice and the
    shift phasors. The gradient is with respect to the pose only: it runs
    through the trilinear weights of the gather, not into Fref."""
    dev = Fref.device
    X = image_to_fourier(stack)
    vol_pad = Fref.shape[0] // n
    # pose_mask (psi, theta, phi, shy, shx) freezes parameters the caller
    # excludes; our pose layout is (phi, theta, psi, sy, sx)
    pm = torch.as_tensor(pose_mask, dtype=torch.float32, device=dev)
    scale = torch.tensor([lr_angles, lr_angles, lr_angles,
                          lr_shifts, lr_shifts], dtype=torch.float32,
                         device=dev) * pm
    w = (torch.ones(mask_pts.shape[0], device=dev) if weights is None
         else torch.as_tensor(weights, dtype=torch.float32, device=dev))

    xv = gather_2d_hermitian(X, mask_pts)                    # (B, G)
    cp = ctf_params[:, :, None]
    c = _ctf_at_points(mask_pts[None], n, pixel_size, cp[:, 0], cp[:, 1],
                       cp[:, 2], voltage_kv, cs_mm, amplitude_contrast,
                       cp[:, 3])                             # (B, G)
    xnorm2 = (w * _abs2(xv)).sum(dim=1)
    xc = w * xv.conj() * c
    c2 = w * c * c

    def score(pose):
        R = euler_to_matrix(pose[:, 0], pose[:, 1], pose[:, 2])  # (B, 3, 3)
        q = (mask_pts[None, :, 1, None] * R[:, None, 0, :]
             + mask_pts[None, :, 0, None] * R[:, None, 1, :])    # (B, G, 3)
        u = gather_3d_hermitian(Fref, q.flip(-1), scale=float(vol_pad))
        ph = 2.0 * np.pi * (mask_pts[None, :, 0] * pose[:, 3:4]
                            + mask_pts[None, :, 1] * pose[:, 4:5]) / n
        phasor = torch.complex(torch.cos(ph), torch.sin(ph))
        num = (xc * phasor * u).real.sum(dim=1)
        den = torch.sqrt(xnorm2 * (c2 * _abs2(u)).sum(dim=1) + 1e-12)
        return num / den

    pose = poses.detach().to(torch.float32)
    m = torch.zeros_like(pose)
    for t in range(iters):
        p = pose.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(score(p).sum(), p)
        gn = g / (torch.linalg.vector_norm(g, dim=1, keepdim=True) + 1e-8)
        m = 0.7 * m + gn
        decay = 0.5 * (1 + math.cos(math.pi * t / iters))
        pose = pose + scale * decay * m
    with torch.no_grad():
        sc0 = score(poses.to(torch.float32))
        sc1 = score(pose)
    better = sc1 >= sc0
    return (torch.where(better[:, None], pose, poses.to(torch.float32)),
            torch.where(better, sc1, sc0))


# ---------------------------------------------------------------------------
# top-level refinement of one batch
# ---------------------------------------------------------------------------

def refine_batch(
    stack,
    ctf_params,
    ref_volume,
    pixel_size: float,
    angular_step: float = 15.0,
    psi_step: float = 10.0,
    low_res: float = 40.0,
    high_res_search: float = 8.0,
    high_res_refine: float = 5.0,
    shift_extent: float = 6.0,
    shift_step: float = 2.0,
    symmetry: str = "C1",
    mode: str = "global",      # "global" | "local"
    init_poses=None,
    topk: int = 4,
    voltage_kv: float = 300.0,
    cs_mm: float = 2.7,
    amplitude_contrast: float = 0.07,
    local_iters: int = 24,
    lr_angles: float = 2.0,
    lr_shifts: float = 0.4,
    shell_weights=None,
    device="cpu",
) -> RefineResult:
    """Full refine3d-equivalent on one batch of particles, on `device`.
    Inputs may be numpy arrays or tensors. `shell_weights` (G,) weights
    matching make_mask_points(low_res, high_res_refine) apply SSNR
    weighting to the local-refinement score (shell_weights_from_fsc)."""
    dev = resolve_device(device)

    def on(x):
        return torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x).to(device=dev, dtype=torch.float32)

    stack = on(stack)
    ctf_params = on(ctf_params)
    n = stack.shape[-1]
    Fref = volume_to_fourier(on(ref_volume))

    pts_refine = on(make_mask_points(n, pixel_size, low_res, high_res_refine))
    refine_kw = dict(voltage_kv=voltage_kv, cs_mm=cs_mm,
                     amplitude_contrast=amplitude_contrast, iters=local_iters,
                     lr_angles=lr_angles, lr_shifts=lr_shifts,
                     weights=shell_weights)
    if mode == "global" or init_poses is None:
        directions = on(make_directions(angular_step, symmetry))
        psis = on(np.arange(0.0, 360.0, psi_step, dtype=np.float32))
        pts_search = on(make_mask_points(n, pixel_size, low_res,
                                         high_res_search))
        shift_grid = on(make_shift_grid(shift_extent, shift_step))
        cand, _ = global_search(
            stack, ctf_params, Fref, directions, psis, pts_search,
            shift_grid, n, pixel_size, voltage_kv, cs_mm,
            amplitude_contrast, topk=topk,
        )  # (B, K, 5)
        B, K = cand.shape[0], cand.shape[1]
        poses_k, scores_k = local_refine(
            stack.repeat_interleave(K, dim=0),
            ctf_params.repeat_interleave(K, dim=0), Fref,
            cand.reshape(B * K, 5), pts_refine, n, pixel_size, **refine_kw)
        scores_k = scores_k.reshape(B, K)
        poses_k = poses_k.reshape(B, K, 5)
        best = torch.argmax(scores_k, dim=1)
        rows = torch.arange(B, device=dev)
        poses = poses_k[rows, best]
        scores = scores_k[rows, best]
    else:
        poses, scores = local_refine(
            stack, ctf_params, Fref, on(init_poses), pts_refine, n,
            pixel_size, **refine_kw)

    # FREALIGN-compatible output statistics: SCORE = 100*NCC; SIGMA = rms
    # residual proxy; LOGP = Gaussian log-likelihood proxy
    G = pts_refine.shape[0]
    sigma = torch.sqrt(torch.clamp(1.0 - scores ** 2, min=1e-6))
    logp = -0.5 * G * torch.log(torch.clamp(sigma, min=1e-6))
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
