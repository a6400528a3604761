"""Per-particle movie refinement ("polishing") — the torch port of
pyp_tpu/ops/polish.py.

Refine a per-particle, per-frame 2D trajectory against CTF-weighted
projections of the current reference, with temporal smoothness
regularization (one differentiable loss over all (particle, frame)
windows, gradient ascent through `torch.autograd.grad`), then sum the
frames with Grant-Grigorieff dose weights into polished particle images.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pyp_tpu_torch import as_f32, resolve_device
from pyp_tpu_torch.core.ctf import dose_weight_2d
from pyp_tpu_torch.core.geometry import euler_to_matrix
from pyp_tpu_torch.ops.fourier_slice import (
    gather_2d_hermitian,
    image_to_fourier,
    slice_at_points,
)
from pyp_tpu_torch.ops.refine3d import _ctf_at_points, make_mask_points


def refine_trajectories(
    windows,            # (P, F, n, n) per-frame particle windows
    poses,              # (P, 5) refined poses (phi, theta, psi, sy, sx)
    ctf_params,         # (P, 4)
    Fref,               # padded reference spectrum
    mask_pts,           # (G, 2)
    n: int,
    pixel_size: float,
    iters: int = 30,
    lr: float = 0.15,
    reg_weight: float = 2.0,
    spatial_sigma: float = 0.0,
    coords=None,
    init_traj=None,
    voltage_kv: float = 300.0,
    cs_mm: float = 2.7,
    amplitude_contrast: float = 0.07,
    device="cuda",
):
    """Returns (traj (P, F, 2) per-frame shifts to ADD to the global shift,
    final mean score), on `device`.

    spatial_sigma > 0 (pixels; needs coords (P, 2)) adds the reference's
    spatial coupling (csp_spatial_sigma): each particle's per-frame shift
    is pulled toward the Gaussian-weighted mean of its neighbours'."""
    dev = resolve_device(device)
    windows = as_f32(windows, dev)
    poses, ctf_params = as_f32(poses, dev), as_f32(ctf_params, dev)
    Fref = Fref.to(dev)
    mask = as_f32(mask_pts, dev)
    P, F = windows.shape[0], windows.shape[1]
    vol_pad = Fref.shape[0] // n
    X = image_to_fourier(windows)                            # (P, F, n, nxf)

    R = euler_to_matrix(poses[:, 0], poses[:, 1], poses[:, 2])
    u = slice_at_points(R, mask, Fref, float(vol_pad))        # (P, G)
    cp = ctf_params[:, :, None]
    c = _ctf_at_points(mask, n, pixel_size, cp[:, 0], cp[:, 1], cp[:, 2],
                       voltage_kv, cs_mm, amplitude_contrast, cp[:, 3])
    cu = c * u                                               # model per particle
    cu_norm = torch.sqrt(torch.sum(cu.real ** 2 + cu.imag ** 2, 1) + 1e-12)
    xv = gather_2d_hermitian(X, mask)                        # (P, F, G)
    x_norm = torch.sqrt(torch.sum(xv.real ** 2 + xv.imag ** 2, 2) + 1e-12)
    # Re(conj(x) cu), Im(conj(x) cu): the phasor is the only term that moves
    a_re = xv.real * cu.real[:, None] + xv.imag * cu.imag[:, None]
    a_im = xv.real * cu.imag[:, None] - xv.imag * cu.real[:, None]
    base_shift = poses[:, 3:5][:, None, :]                   # (P, 1, 2)

    W_sp = None
    if spatial_sigma and spatial_sigma > 0 and coords is not None and P > 1:
        cc = as_f32(coords, dev)
        d2c = torch.sum((cc[:, None, :] - cc[None, :, :]) ** 2, -1)
        W_sp = torch.exp(-0.5 * d2c / (spatial_sigma ** 2))
        W_sp = W_sp - torch.diag(torch.diag(W_sp))           # neighbours only
        W_sp = W_sp / (torch.sum(W_sp, 1, keepdim=True) + 1e-9)

    def score_fn(traj):
        s = base_shift + traj                                # (P, F, 2)
        ph = (2.0 * math.pi / n) * (mask[:, 0] * s[..., 0:1]
                                    + mask[:, 1] * s[..., 1:2])
        num = torch.sum(a_re * torch.cos(ph) - a_im * torch.sin(ph), 2)
        ncc = num / (x_norm * cu_norm[:, None])
        d2 = traj[:, 2:] - 2 * traj[:, 1:-1] + traj[:, :-2]
        score = torch.mean(ncc) - reg_weight * torch.mean(d2 * d2)
        if W_sp is not None:
            resid = traj - torch.einsum("pq,qfc->pfc", W_sp, traj)
            score = score - reg_weight * torch.mean(resid * resid)
        return score

    traj0 = (torch.zeros((P, F, 2), device=dev) if init_traj is None
             else as_f32(init_traj, dev))
    traj, m = traj0, torch.zeros_like(traj0)
    for t in range(iters):
        x = traj.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(score_fn(x), [x])
        m = 0.7 * m + g / (torch.linalg.vector_norm(g) + 1e-9)
        decay = 0.5 * (1 + math.cos(math.pi * t / iters))
        traj = traj + lr * decay * m
    with torch.no_grad():
        better = score_fn(traj) >= score_fn(traj0)
        traj = torch.where(better, traj, traj0)
        return traj, score_fn(traj)


def polished_average(windows, traj, doses, pixel_size: float = 1.0):
    """Dose-weighted per-particle frame sum at the refined trajectory, on
    the device of `windows`.

    windows: (P, F, n, n); traj: (P, F, 2); doses: (F,). -> (P, n, n)."""
    P, F, n, _ = windows.shape
    dev = windows.device
    Xf = torch.fft.rfft2(windows)
    ky = torch.as_tensor(np.fft.fftfreq(n).astype(np.float32),
                         device=dev).reshape(n, 1)
    kx = torch.as_tensor(np.fft.rfftfreq(n).astype(np.float32),
                         device=dev).reshape(1, -1)
    traj = as_f32(traj, dev)
    ph = -2.0 * math.pi * (ky * traj[..., 0, None, None]
                           + kx * traj[..., 1, None, None])
    Xs = Xf * torch.polar(torch.ones_like(ph), ph)
    w = dose_weight_2d((n, n), pixel_size, as_f32(doses, dev))  # (F, n, nxf)
    return torch.fft.irfft2(torch.sum(Xs * w[None], 1), s=(n, n)) / F


def polish(frames, coords, poses, ctf_params, ref_volume, pixel_size: float,
           boxsize: int, doses=None, global_shifts=None, device="cuda", **kw):
    """Full polishing pass for one micrograph movie on `device`: window
    every particle from every frame (at drift-corrected positions), refine
    trajectories, return (polished stack (P, n, n), traj (P, F, 2))."""
    from pyp_tpu_torch.ops.extract import extract_from_frames
    from pyp_tpu_torch.ops.fourier_slice import volume_to_fourier

    dev = resolve_device(device)
    frames = as_f32(frames, dev)
    F = frames.shape[0]
    windows = extract_from_frames(frames, coords, boxsize,
                                  shifts=global_shifts, invert=False,
                                  normalize=False, device=dev)
    Fref = volume_to_fourier(as_f32(ref_volume, dev))
    mask_pts = make_mask_points(boxsize, pixel_size, 60.0, 3.0 * pixel_size)
    kw.setdefault("coords", np.asarray(coords, dtype=np.float32))
    traj, _score = refine_trajectories(
        windows, poses, ctf_params, Fref, mask_pts, boxsize, pixel_size,
        device=dev, **kw)
    if doses is None:
        doses = torch.arange(1, F + 1, dtype=torch.float32, device=dev)
    return polished_average(windows, traj, doses, pixel_size), traj
