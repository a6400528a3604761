"""Synthetic SPA dataset, the refine protocols run on it, and ground-truth
scoring — the torch port of the dataset maker and validation of
tools/benchmark_e2e_spa.py.

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
# The reference protocol itself (tools/benchmark_e2e_spa.py:137-153,
# docs/BENCH_E2E.md:131-135): the FRM engine with gold-standard half banks,
# iterations 2 (global) to 5 (local, final: sub-lattice polish and a
# full-size reconstruction) at rhref 12, 10, 8, 7 Å.
FRM_ARGS = [
    "refine", "-refine_engine", "frm", "-refine_maxiter", "4",
    "-refine_rhref", "12:10:8:7:6:5", "-refine_dang", "7.5",
    "-refine_psi_step", "5", "-refine_searchx", "6", "-refine_rlref", "50",
    "-refine_frm_cone", "15", "-refine_frm_wiener", "0.1",
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
    vol = phantom(rng, box, pixel, content_a, dev)
    phi = rng.uniform(0, 360, n_particles).astype(np.float32)
    theta = np.degrees(np.arccos(rng.uniform(-1, 1, n_particles))).astype(np.float32)
    psi = rng.uniform(0, 360, n_particles).astype(np.float32)
    return {"volume": vol, **project_particles(
        vol, rng, phi, theta, psi, pixel, noise_x, shift_max, dev, batch)}


def phantom(rng, box=128, pixel=1.0, content_a=5.0, device="cpu"):
    """The truth: white noise from `rng` inside a sphere of radius
    0.35 box, low-passed to `content_a` Å, times 10 (numpy float32)."""
    mask = soft_spherical_mask(box, box * 0.35, 4.0).numpy()
    vol = rng.randn(box, box, box).astype(np.float32) * mask
    return lowpass_filter_3d(torch.from_numpy(vol).to(resolve_device(device)),
                             pixel, max(content_a, 2.0 * pixel)
                             ).cpu().numpy() * 10.0


def project_particles(vol, rng, phi, theta, psi, pixel=1.0, noise_x=3.0,
                      shift_max=4.0, device="cpu", batch=512):
    """Particles of `vol` at the given angles: shifts uniform in
    +-shift_max px and defoci uniform in 0.8-2.8 µm (400 Å astigmatism,
    random angle) drawn from `rng`, the CTF-modulated central slices
    shifted, then white noise `noise_x` times each batch's signal std.
    Returns a dict: stack, ctf_params, phi, theta, psi, shifts (numpy
    float32)."""
    dev = resolve_device(device)
    box = vol.shape[-1]
    n_particles = len(phi)
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
    return {"stack": stack, "ctf_params": ctf_params, "phi": phi,
            "theta": theta, "psi": psi, "shifts": shifts}


def starting_map(volume, pixel=1.0, resolution=20.0):
    """The refinement's starting reference: a low-pass of the truth (the
    realistic case of an external or ab initio model)."""
    return lowpass_filter_3d(torch.as_tensor(volume), pixel,
                             resolution).numpy().astype(np.float32)


def write_project(work_dir, data, initial_model, pixel=1.0):
    """stack.mrc, stack.cistem (CTF, zero poses) and initial_model.mrc in
    `work_dir`: the inputs of the `refine` mode."""
    from pyp_tpu_torch.io import cistem, mrc

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


def write_pseudo_atom_pdb(volume, pixel, n_atoms, path):
    """Test data for model fitting: the `n_atoms` densest voxels of a map
    written as carbon ATOM records (x, y, z in Å about the box centre),
    each with its density relative to the densest as occupancy. Returns
    `path`."""
    vol = np.asarray(volume, dtype=np.float32)
    n = vol.shape[-1]
    flat = vol.reshape(-1)
    top = np.argsort(flat)[::-1][:int(n_atoms)]
    zyx = np.stack(np.unravel_index(top, vol.shape), 1).astype(np.float32)
    xyz = (zyx[:, ::-1] - n // 2) * pixel
    occ = np.clip(flat[top] / flat[top[0]], 0.01, 1.0)
    with open(path, "w") as f:
        for i, ((x, y, z), o) in enumerate(zip(xyz, occ), start=1):
            # PDB v3 columns: serial 7-11, name 13-16, resName 18-20,
            # chain 22, resSeq 23-26, x/y/z 31-54, occupancy 55-60,
            # B 61-66, element 77-78
            f.write(f"ATOM  {i % 100000:5d} C    ALA A{1:4d}    "
                    f"{x:8.3f}{y:8.3f}{z:8.3f}{o:6.2f}{0.0:6.2f}"
                    f"           C\n")
        f.write("END\n")
    return str(path)
