"""Synthetic SPA dataset and ground-truth scoring — the torch port of the
dataset maker and validation of tools/benchmark_e2e_spa.py.

The phantom is a masked, low-passed random volume; particles are
CTF-modulated central slices at random poses (uniform on the sphere),
shifted by up to `shift_max` px, with white noise `noise_x` times the
signal's standard deviation. Everything random comes from one
`numpy.random.RandomState(seed)`, so the same seed gives the same dataset
on any device.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from pyp_tpu_torch import resolve_device
from pyp_tpu_torch.core.filters import lowpass_filter_3d, soft_spherical_mask
from pyp_tpu_torch.core.geometry import euler_to_matrix
from pyp_tpu_torch.ops import fourier_slice as fs
from pyp_tpu_torch.ops.reconstruct import _ctf_grids, _shift_correct

# The gather-engine slice's protocol: the reference's synthetic e2e
# (docs/BENCH_E2E.md:131-135) with the engine switched to gather. The
# starting map is a 20 Å low-pass of the truth; iteration 2 is global
# (zero-pose table), iterations 3 and 4 are local.
SLICE = dict(n_particles=4096, box=128, pixel=1.0, noise_x=3.0,
             content_a=5.0, shift_max=4.0, seed=0)
START_RESOLUTION = 20.0
REFINE_ARGS = [
    "refine", "-refine_engine", "gather", "-refine_maxiter", "3",
    "-refine_rhref", "12:10:8:7", "-refine_dang", "7.5",
    "-refine_psi_step", "5", "-refine_searchx", "6", "-refine_rlref", "50",
    "-particle_sym", "C1", "-refine_goldstandard", "-no_plot_per_item",
    "-scope_pixel", "1.0",
]


def make_dataset(n_particles=4096, box=128, pixel=1.0, noise_x=3.0,
                 content_a=5.0, shift_max=4.0, seed=0, device="cpu",
                 batch=512):
    """Returns a dict: volume (box^3 truth), stack (n, box, box), ctf_params
    (n, 4), phi, theta, psi (degrees) and shifts (n, 2) px (the content
    offset; the refined centering shift is its negative). Arrays are numpy
    float32."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    mask = soft_spherical_mask(box, box * 0.35, 4.0).numpy()
    vol = rng.randn(box, box, box).astype(np.float32) * mask
    vol = lowpass_filter_3d(torch.from_numpy(vol).to(dev), pixel,
                            max(content_a, 2.0 * pixel)).cpu().numpy() * 10.0

    phi = rng.uniform(0, 360, n_particles).astype(np.float32)
    theta = np.degrees(np.arccos(rng.uniform(-1, 1, n_particles))).astype(np.float32)
    psi = rng.uniform(0, 360, n_particles).astype(np.float32)
    shifts = rng.uniform(-shift_max, shift_max, (n_particles, 2)).astype(np.float32)
    df = rng.uniform(8000, 28000, n_particles).astype(np.float32)
    ctf_params = np.stack(
        [df + 400, df - 400, rng.uniform(0, 180, n_particles),
         np.zeros(n_particles)], 1).astype(np.float32)

    Fvol = fs.volume_to_fourier(torch.from_numpy(vol).to(dev))
    stack = np.empty((n_particles, box, box), dtype=np.float32)
    for lo in range(0, n_particles, batch):
        hi = min(lo + batch, n_particles)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a[lo:hi])).to(dev)

        R = euler_to_matrix(t(phi), t(theta), t(psi))
        F = fs.project(Fvol, R, box)
        F = _shift_correct(F * _ctf_grids(box, pixel, t(ctf_params), 300.0,
                                          2.7, 0.07), t(shifts), box)
        imgs = fs.fourier_to_image(F, box).cpu().numpy()
        noise = rng.randn(*imgs.shape).astype(np.float32)
        stack[lo:hi] = imgs + noise * noise_x * imgs.std()
    return {"volume": vol, "stack": stack, "ctf_params": ctf_params,
            "phi": phi, "theta": theta, "psi": psi, "shifts": shifts}


def starting_map(volume, pixel=1.0, resolution=20.0):
    """The refinement's starting reference: a low-pass of the truth (the
    realistic case of an external or ab initio model)."""
    return lowpass_filter_3d(torch.as_tensor(volume), pixel,
                             resolution).numpy().astype(np.float32)


def write_project(work_dir, data, initial_model, pixel=1.0):
    """stack.mrc, stack.cistem (CTF, zero poses) and initial_model.mrc in
    `work_dir`: the inputs of the `refine` mode."""
    from pyp_tpu.io import cistem, mrc

    work_dir = Path(work_dir)
    n = len(data["stack"])
    cp = data["ctf_params"]
    table = cistem.Table.zeros(n)
    table["position_in_stack"] = np.arange(1, n + 1)
    table["pixel_size"] = np.full(n, pixel)
    table["defocus_1"] = cp[:, 0]
    table["defocus_2"] = cp[:, 1]
    table["defocus_angle"] = cp[:, 2]
    table["occupancy"] = np.full(n, 100.0)
    mrc.write(data["stack"], work_dir / "stack.mrc", pixel_size=pixel)
    cistem.write_parameters(table, work_dir / "stack.cistem")
    mrc.write(np.asarray(initial_model, dtype=np.float32),
              work_dir / "initial_model.mrc", pixel_size=pixel)


def angular_error_deg(phi, theta, psi, data):
    """Per-particle rotation angle (degrees) between refined and true
    orientations."""
    def R(a, b, c):
        return euler_to_matrix(*(torch.as_tensor(np.asarray(x, dtype=np.float32))
                                 for x in (a, b, c)))

    tr = torch.einsum("bij,bij->b", R(phi, theta, psi),
                      R(data["phi"], data["theta"], data["psi"])).numpy()
    return np.degrees(np.arccos(np.clip((tr - 1) / 2, -1, 1)))


def masked_cc(volume_map, truth, pixel=1.0, resolution=10.0):
    """Correlation of a map with the truth inside the particle mask, both
    low-passed to `resolution` Å (where the signal lives)."""
    box = truth.shape[-1]

    def lp(v):
        return lowpass_filter_3d(torch.as_tensor(np.asarray(v, dtype=np.float32)),
                                 pixel, resolution).numpy()

    m = soft_spherical_mask(box, box * 0.35, 4.0).numpy() > 0.5
    return float(np.corrcoef(lp(volume_map)[m].ravel(),
                             lp(truth)[m].ravel())[0, 1])
