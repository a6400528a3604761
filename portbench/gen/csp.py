"""Synthetic tilt-series batch for constrained single-particle tomography.

S series of T tilts at +-tilt_max degrees, each holding P particles of one
seeded phantom: white noise inside a soft sphere of radius 0.35 box,
low-passed to `content_a` Å. The truth: per-series tilt-angle and
tilt-axis errors and per-tilt image shifts that drift smoothly over the
series, particle orientations uniform on the sphere, positions uniform in
the tomogram slab, per-series defocus with the particles' depth. Each
window is the CTF'd projection of its particle, its content offset by
where the truth puts it from the window's integer centre, plus white noise
`noise_x` times the clean windows' standard deviation. The start is the
truth perturbed within what one pass of the mode schedule can move
(`perturb`), and the windows are centred where the start predicts them, as
a pipeline cuts them. Every random number comes from the run's seed.
"""

from __future__ import annotations

import torch

from portbench.reference import fourier as rf
from portbench.reference.score import csp_geometry


def generator(seed, device):
    return torch.Generator(device=device).manual_seed(int(seed))


def phantom(gen, box, pixel, content_a, device):
    vol = torch.randn((box, box, box), generator=gen, device=device)
    vol = vol * rf.soft_sphere(box, box * 0.35, 4.0, device)
    return rf.lowpass_3d(vol, pixel, max(content_a, 2.0 * pixel)) * 10.0


def uniform(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def _smooth(gen, S, T, amp, device, dims=()):
    """(S, T, *dims) values drifting as a random quadratic over the tilts,
    within +-amp."""
    t = torch.linspace(-1.0, 1.0, T, device=device)
    shape = (S, 1) + tuple(dims)
    a1 = uniform(gen, shape, -0.5, 0.5, device)
    a2 = uniform(gen, shape, -0.5, 0.5, device)
    tt = t.reshape((1, T) + (1,) * len(dims))
    return amp * (a1 * tt + a2 * (tt * tt - 1.0 / 3.0))


def make(seed, series, tilts, particles_per_series, box, pixel, tilt_max,
         noise_x, content_a, slab, df_range, axis_deg, truth, perturb, device,
         chunk=4096, **_):
    """S = series series of T = tilts tilts and P = particles_per_series
    particles: dict of the truth and start parameters (each a dict of tilt (S, T),
    axis (S, T), shifts (S, T, 2), eulers (S, P, 3), pos (S, P, 3),
    df_offsets (S, T)), volume (box^3), windows (S, T, P, box, box),
    centres (S, T, P, 2) and tilt_df (S, T), float32 on `device`."""
    S, T, P = series, tilts, particles_per_series
    gen = generator(seed, device)
    dev = device
    vol = phantom(gen, box, pixel, content_a, dev)
    nominal = torch.linspace(-tilt_max, tilt_max, T, device=dev).expand(S, T)
    true = {
        "tilt": nominal + _smooth(gen, S, T, truth["tilt_deg"], dev),
        "axis": axis_deg + _smooth(gen, S, T, truth["axis_deg"], dev),
        "shifts": _smooth(gen, S, T, truth["shift_px"], dev, (2,)),
        "eulers": torch.stack([
            uniform(gen, (S, P), 0.0, 360.0, dev),
            torch.rad2deg(torch.arccos(uniform(gen, (S, P), -1.0, 1.0, dev))),
            uniform(gen, (S, P), 0.0, 360.0, dev)], -1),
        "pos": torch.cat([uniform(gen, (S, P, 1), -slab[0], slab[0], dev),
                          uniform(gen, (S, P, 2), -slab[1], slab[1], dev)], -1),
        "df_offsets": torch.zeros((S, T), device=dev),
    }
    start = {
        "tilt": nominal.clone(),
        "axis": torch.full((S, T), float(axis_deg), device=dev),
        "shifts": true["shifts"] + perturb["shift_px"] * torch.randn(
            (S, T, 2), generator=gen, device=dev),
        "eulers": true["eulers"] + perturb["euler_deg"] * torch.randn(
            (S, P, 3), generator=gen, device=dev),
        "pos": true["pos"] + perturb["pos_px"] * torch.randn(
            (S, P, 3), generator=gen, device=dev),
        "df_offsets": torch.zeros((S, T), device=dev),
    }
    tilt_df = uniform(gen, (S, 1), *df_range, dev).expand(S, T).contiguous()
    _, proj_start, _ = csp_geometry(start["tilt"], start["axis"],
                                    start["shifts"], start["eulers"], start["pos"])
    centres = torch.round(proj_start)
    R_eff, proj, depth = csp_geometry(true["tilt"], true["axis"], true["shifts"],
                                      true["eulers"], true["pos"])
    offset = (proj - centres).reshape(-1, 2)
    df = (tilt_df[:, :, None] + depth * pixel).reshape(-1)
    R_eff = R_eff.reshape(-1, 3, 3)
    Fvol = rf.volume_to_fourier(vol, 2)
    hp = rf.half_plane(box, dev)
    B = R_eff.shape[0]
    wins = torch.empty((B, box, box), device=dev)
    for lo in range(0, B, chunk):
        sl = slice(lo, min(lo + chunk, B))
        F = rf.project(Fvol, R_eff[sl], box)
        d = df[sl, None, None]
        F = F * rf.ctf(hp[None], box, pixel, d, d, 0.0)
        F = F * rf.shift_phase(hp.reshape(-1, 2), offset[sl], box).reshape(F.shape)
        wins[sl] = rf.fourier_to_image(F, box)
    wins += torch.randn(wins.shape, generator=gen, device=dev) * (
        noise_x * wins.std())
    return {"true": true, "start": start, "volume": vol,
            "windows": wins.reshape(S, T, P, box, box), "centres": centres,
            "tilt_df": tilt_df}
