"""Synthetic movie set for the preprocessing path, and its ground-truth
scoring — the counterpart of `e2e_spa` one stage earlier: counting-camera
movies with a planted drift, CTF and particle positions, which `spr` and
`extract` turn back into a particle stack.

A micrograph is a jittered grid of projections of one volume (the truth
of `e2e_spa` plus a soft solvent-contrast sphere, so that a particle is a
dark blob at low resolution, as a protein in ice is) on a white "ice"
background, modulated by one astigmatic CTF. Each frame is that image
shifted along a planted trajectory (an exponential decay in y and a
quadratic in x, zero mean, rotated and scaled per movie) and sampled as
Poisson counts at `dose` electrons per pixel and frame. Everything random
comes from one `numpy.random.RandomState(seed)` (positions, poses, CTF,
drift) and one seeded `torch.Generator` on the device (ice, counts), so a
seed gives the same set on the same kind of device.

It is a fixture for the smoke run and the tests, not a user feature.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from pyp_tpu_torch import as_f32, resolve_device
from pyp_tpu_torch.core.ctf import ctf_2d
from pyp_tpu_torch.core.fft import phase_ramp
from pyp_tpu_torch.core.filters import soft_spherical_mask
from pyp_tpu_torch.core.geometry import euler_to_matrix
from pyp_tpu_torch.ops import fourier_slice as fs

# The smoke run's set: K3-size movies (40 frames x 4096²) at 1 Å/px, 256
# particles of box 128 each on a 16 x 16 grid of 224 px cells, 256 px
# clear of the edges (the picker's contamination mask averages over 361 px
# windows with zero ends, so it flags a border of about half a window).
MOVIES = dict(n_movies=3, n_frames=40, size=4096, cell=224, jitter=48,
              margin=256, pixel=1.0, dose=1.0, contrast=0.15, ice=1.0, envelope=0.5,
              drift_px=6.0, seed=0)
PARTICLE_RADIUS_A = 45.0     # 0.35 x box 128 at 1 Å/px: the volume's mask
# what the preprocessing of such a set is run with (cli.main(["spr", ...]))
SPR_ARGS = [
    "spr", "-scope_pixel", "1.0", "-scope_voltage", "300", "-scope_cs", "2.7",
    "-scope_wgh", "0.07", "-scope_dose_rate", "1.0",
    "-detect_rad", str(PARTICLE_RADIUS_A), "-detect_thresh", "3.0",
    "-extract_box", "128", "-ctf_min_def", "5000", "-ctf_max_def", "40000",
    "-no_plot_per_item",
]


def with_envelope(volume, envelope=0.5):
    """The particle the movies show: `volume` plus `envelope` x its std of
    a soft sphere over its mask radius (numpy in, numpy out)."""
    vol = np.asarray(volume, dtype=np.float32)
    n = vol.shape[-1]
    sphere = soft_spherical_mask(n, n * 0.35, 4.0).numpy()
    return (vol + envelope * vol.std() * sphere).astype(np.float32)


def planted_trajectory(n_frames, drift_px, angle_rad=0.0, scale=1.0):
    """(n_frames, 2) zero-mean content offsets (y, x) in px: a fast early
    decay and a slow quadratic, like beam-induced motion."""
    t = np.linspace(0.0, 1.0, n_frames)
    traj = np.stack([drift_px * (1 - np.exp(-3 * t)),
                     -0.6 * drift_px * t ** 2], axis=1) * scale
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    traj = traj @ np.array([[c, -s], [s, c]]).T
    return (traj - traj.mean(axis=0, keepdims=True)).astype(np.float32)


def make_movie(volume, n_frames=40, size=4096, cell=224, jitter=48,
               margin=256, pixel=1.0, dose=1.0, contrast=0.15, ice=1.0, envelope=0.5,
               drift_px=6.0, seed=0, device="cuda"):
    """One movie: returns (frames (n_frames, size, size) int8 tensor of
    counts on `device`, truth dict of plain lists and floats: centres
    (y, x), trajectory, df1, df2, angast, phi/theta/psi)."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    box = volume.shape[-1]
    n_side = (size - 2 * margin) // cell
    n = n_side * n_side
    gy, gx = np.meshgrid(np.arange(n_side), np.arange(n_side), indexing="ij")
    centres = (np.stack([gy.ravel(), gx.ravel()], 1) * cell + cell // 2
               + (size - n_side * cell) // 2
               + rng.randint(-jitter, jitter + 1, (n, 2)))
    phi = rng.uniform(0, 360, n).astype(np.float32)
    theta = np.degrees(np.arccos(rng.uniform(-1, 1, n))).astype(np.float32)
    psi = rng.uniform(0, 360, n).astype(np.float32)
    df = rng.uniform(15000.0, 25000.0)
    astig = rng.uniform(500.0, 1000.0)
    angast = rng.uniform(0.0, 180.0)
    traj = planted_trajectory(n_frames, drift_px, rng.uniform(0, 2 * np.pi),
                              rng.uniform(0.8, 1.2))

    Fvol = fs.volume_to_fourier(as_f32(with_envelope(volume, envelope), dev))
    canvas = torch.zeros((size, size), dtype=torch.float32, device=dev)
    half = box // 2
    for lo in range(0, n, 64):
        R = euler_to_matrix(*(as_f32(a[lo:lo + 64], dev)
                              for a in (phi, theta, psi)))
        proj = fs.fourier_to_image(fs.project(Fvol, R, box), box)
        for p, (cy, cx) in zip(proj, centres[lo:lo + 64]):
            canvas[cy - half:cy + half, cx - half:cx + half] += p
    inside = canvas != 0
    canvas += ice * canvas[inside].std() * torch.randn(
        canvas.shape, generator=gen, device=dev)
    ctf = ctf_2d((size, size), pixel, torch.tensor(df + astig / 2, device=dev),
                 torch.tensor(df - astig / 2, device=dev),
                 torch.tensor(angast, device=dev), 300.0, 2.7, 0.07)
    F = torch.fft.rfft2(canvas) * ctf
    image = torch.fft.irfft2(F, s=(size, size))
    F *= contrast / image[inside].std()
    del canvas, image, ctf

    frames = torch.empty((n_frames, size, size), dtype=torch.int8, device=dev)
    shifts = as_f32(traj, dev)
    for f in range(n_frames):
        img = torch.fft.irfft2(F * phase_ramp(shifts[f], size, size),
                               s=(size, size))
        rate = dose * torch.clamp(1.0 + img, min=0.0)
        frames[f] = torch.clamp(torch.poisson(rate, generator=gen),
                                max=127).to(torch.int8)
    truth = {"centres": centres.tolist(), "trajectory": traj.tolist(),
             "df1": df + astig / 2, "df2": df - astig / 2, "angast": angast,
             "phi": phi.tolist(), "theta": theta.tolist(),
             "psi": psi.tolist()}
    return frames, truth


def write_movies(out_dir, volume, n_movies=3, seed=0, device="cuda", **kw):
    """`n_movies` movies as MRC mode 0 (int8 counts) under `out_dir`
    (movie_00.mrc, ...) and their planted truth as truth.json; returns
    (the truth by movie name, the bytes written)."""
    from pyp_tpu_torch.io import mrc

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    truth, nbytes = {}, 0
    for i in range(n_movies):
        frames, t = make_movie(volume, seed=seed + i, device=device, **kw)
        name = f"movie_{i:02d}"
        mrc.write(frames.cpu().numpy(), out_dir / f"{name}.mrc",
                  pixel_size=float(kw.get("pixel", 1.0)))
        nbytes += (out_dir / f"{name}.mrc").stat().st_size
        truth[name] = t
    (out_dir / "truth.json").write_text(json.dumps(truth))
    return truth, nbytes


def drift_rms_error(drift, trajectory):
    """RMS distance (px) over frames between the estimated aligning shifts
    and the planted ones: aligning a frame undoes its content offset, and
    both are taken about their means."""
    est = np.asarray(drift, dtype=np.float64)
    want = -np.asarray(trajectory, dtype=np.float64)
    est = est - est.mean(axis=0)
    want = want - want.mean(axis=0)
    return float(np.sqrt(((est - want) ** 2).sum(axis=1).mean()))


def pick_recall_precision(found, planted, tol_px):
    """(recall, precision) of picks (N, 2) against planted centres (M, 2):
    a planted centre is found when a pick lies within `tol_px` of it, a
    pick is true when a planted centre lies within `tol_px` of it."""
    found = np.asarray(found, dtype=np.float64).reshape(-1, 2)
    planted = np.asarray(planted, dtype=np.float64).reshape(-1, 2)
    if not len(found) or not len(planted):
        return 0.0, 0.0
    d = np.sqrt(((found[:, None] - planted[None]) ** 2).sum(-1))
    return (float((d.min(axis=0) <= tol_px).mean()),
            float((d.min(axis=1) <= tol_px).mean()))


def angle_error_deg(a, b):
    """Distance between two astigmatism angles (period 180°)."""
    return float(abs((a - b + 90.0) % 180.0 - 90.0))
