"""Synthetic datasets with ground truth for ab initio and classification,
on `tools/e2e_spa`'s truth (the masked, low-passed random phantom) and its
particle recipe (CTF-modulated central slices, shifts, white noise):

  * `views_dataset`: 2D classes, particles of a few well-separated views,
    each at a random in-plane angle (labels = the view);
  * `two_state_dataset`: 3D classes, particles of the truth (state A) and
    of the truth plus a soft blob (state B) at their true poses, with a
    project table that carries those poses (the consensus);
  * `purity`: cluster purity against labels, greedy per cluster.

Everything random comes from `numpy.random.RandomState(seed)`.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from pyp_tpu_torch.core.geometry import euler_to_matrix
from pyp_tpu_torch.tools import e2e_spa


def _axis(phi, theta):
    return euler_to_matrix(float(phi), float(theta), 0.0).numpy()[2]


def views_dataset(n_views=8, per_view=512, box=128, pixel=1.0, noise_x=3.0,
                  shift_max=2.0, min_separation_deg=30.0, seed=0,
                  device="cpu"):
    """`per_view` particles of each of `n_views` views of the e2e truth
    whose viewing axes are at least `min_separation_deg` apart (and from
    each other's antipodes), each particle at a uniform random psi, with
    +-shift_max px shifts, the e2e defocus range and noise `noise_x` times
    the signal std. Returns e2e_spa.make_dataset's dict plus "labels"
    (n,) view index and "views" (n_views, 2) (phi, theta)."""
    rng = np.random.RandomState(seed)
    truth = e2e_spa.phantom(rng, box, pixel, device=device)
    cos_min = np.cos(np.radians(min_separation_deg))
    views, axes = [], []
    while len(views) < n_views:
        phi = rng.uniform(0, 360)
        theta = np.degrees(np.arccos(rng.uniform(-1, 1)))
        a = _axis(phi, theta)
        if all(abs(float(a @ b)) < cos_min for b in axes):
            views.append((phi, theta))
            axes.append(a)
    labels = np.repeat(np.arange(n_views), per_view)
    views = np.asarray(views, dtype=np.float32)
    psi = rng.uniform(0, 360, len(labels)).astype(np.float32)
    out = e2e_spa.project_particles(
        truth, rng, views[labels, 0], views[labels, 1], psi, pixel, noise_x,
        shift_max, device)
    return {"volume": truth, "labels": labels, "views": views, **out}


def blob_state(volume, center_px=(20.0, 0.0, 0.0), radius_px=10.0,
               edge_px=3.0):
    """State B: the volume plus a soft sphere at centre (x, y, z) px from
    the box centre, of amplitude the volume's 99th percentile."""
    n = volume.shape[-1]
    ax = np.arange(n) - n // 2
    x, y, z = center_px
    r = np.sqrt((ax[None, None, :] - x) ** 2 + (ax[None, :, None] - y) ** 2
                + (ax[:, None, None] - z) ** 2)
    soft = np.clip((radius_px + edge_px - r) / edge_px, 0.0, 1.0)
    return (volume + np.percentile(volume, 99) * soft).astype(np.float32)


def two_state_dataset(per_state=2048, box=128, pixel=1.0, noise_x=3.0,
                      shift_max=1.0, seed=0, device="cpu"):
    """`per_state` particles of the e2e truth (state A, label 0) and of
    `blob_state` of it (state B, label 1), uniform poses on the sphere,
    the e2e CTF range and noise. Returns a dict: volumes (A, B), stack,
    ctf_params, phi, theta, psi, shifts, labels."""
    rng = np.random.RandomState(seed)
    truth = e2e_spa.phantom(rng, box, pixel, device=device)
    vols = (truth, blob_state(truth))
    parts = []
    for vol in vols:
        phi = rng.uniform(0, 360, per_state).astype(np.float32)
        theta = np.degrees(np.arccos(rng.uniform(-1, 1, per_state))).astype(np.float32)
        psi = rng.uniform(0, 360, per_state).astype(np.float32)
        parts.append(e2e_spa.project_particles(
            vol, rng, phi, theta, psi, pixel, noise_x, shift_max, device))
    out = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    out["labels"] = np.repeat([0, 1], per_state)
    out["volumes"] = vols
    return out


def write_posed_project(work_dir, data, initial_model, pixel=1.0):
    """e2e_spa.write_project with the table's poses set to the truth (the
    consensus a 3D classification starts from)."""
    from pyp_tpu_torch.io import cistem

    e2e_spa.write_project(work_dir, data, initial_model, pixel=pixel)
    path = Path(work_dir) / "stack.cistem"
    table = cistem.read_parameters(path)
    table["phi"], table["theta"], table["psi"] = (
        data["phi"], data["theta"], data["psi"])
    table["y_shift"] = -data["shifts"][:, 0] * pixel
    table["x_shift"] = -data["shifts"][:, 1] * pixel
    cistem.write_parameters(table, path)


def purity(assign, labels):
    """Sum over clusters of their most common label's count, over all:
    1 for a perfect clustering up to relabelling."""
    assign = np.asarray(assign).astype(int)
    labels = np.asarray(labels).astype(int)
    total = 0
    for k in np.unique(assign):
        total += np.bincount(labels[assign == k]).max()
    return total / len(labels)


def cc(a, b):
    return float(np.corrcoef(np.ravel(a), np.ravel(b))[0, 1])


def aligned_cc(volume_map, truth, pixel=1.0, resolution=10.0, device="cpu"):
    """The map rigidly aligned to the truth over rotations and the hand
    (ops.template_match.align_volumes), then e2e_spa.masked_cc at
    `resolution`. Returns (masked cc, align_volumes' cc, angles,
    flipped)."""
    from pyp_tpu_torch.ops.template_match import align_volumes

    c, angles, flipped, aligned = align_volumes(volume_map, truth,
                                                device=device)
    return (e2e_spa.masked_cc(aligned, truth, pixel, resolution), c, angles,
            flipped)
