"""The CSP fixture: `tools/e2e_tomo`'s planted series turned into a CSP
start, and the CSP result scored against the truth — written without
calling the code under test (numpy rotations and Euler angles, the
fixture's own projection).

The start. The `tomo` run picks the planted particles in its tomogram;
each planted particle keeps the pick nearest to it within its radius
(unbinned voxels, centred as the `csp` mode centres them;
`matched_picks`), and its rotation the fixture recovers exactly from its
planted points (a least-squares fit of the
canonical cloud, `e2e_tomo.particle_offsets`). The start eulers are those
rotations turned by `error_deg` about a random axis each (so the start's
orientation error is exactly `error_deg`), written as a .cistem table in
the picks' order and given to `csp` by -csp_parfile.

The reference. The series shows the particles BRIGHT (positive weight in
the counts, `e2e_tomo`), and the CSP model's CTF is -sin(chi + amp), the
cryo-EM convention in which density is dark at low resolution. So the
reference that correlates positively with the tilts is the NEGATED
particle map, `reference(truth, box, pixel)`; the average CSP writes
comes out in the same sign.

The conventions. Euler angles are ZYZ, R = Rz(psi) Ry(theta) Rz(phi),
mapping reference xyz to tomogram xyz; the planted clouds are stored
(z, y, x), so a planted rotation R_zyx is P R_zyx P in xyz (P reverses
the axes).

It is a fixture for the smoke run and the tests, not a user feature.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

from pyp_tpu_torch.tools import e2e_tomo

# the CSP run on e2e_tomo.SERIES: a box that holds the particle (R 100 Å,
# Gaussians of 45 Å within 45 Å of its centre) at 1 Å/px, and a band the
# blurred particle carries signal in (its Gaussians fall to 2% at 100 Å)
CSP_BOX = 256
CSP_BAND = (400.0, 60.0)           # csp_rlref, csp_rhref (Å)
START_ERROR_DEG = 8.0              # the default schedule's start
GRID_START_ERROR_DEG = 16.0        # the -csp_GridSearch run's start
CSP_ARGS = ["csp", "-scope_pixel", "1.0", "-scope_voltage", "300",
            "-scope_cs", "2.7", "-scope_wgh", "0.07",
            "-csp_box", str(CSP_BOX), "-csp_rlref", str(CSP_BAND[0]),
            "-csp_rhref", str(CSP_BAND[1]), "-no_plot_per_item"]
PERM = np.eye(3)[::-1]


def planted_rotations(truth):
    """(N, 3, 3) rotations of the planted particles in the CSP convention
    (reference xyz -> tomogram xyz), recovered from the planted points."""
    classes, _, _ = e2e_tomo.make_truth(**e2e_tomo._layout_kw(truth))
    spread, _ = e2e_tomo._particle_shape(truth)
    off = e2e_tomo.particle_offsets(truth["particle_radius"],
                                    spread=spread)              # (6, 3) zyx
    pts = np.asarray(classes["particle"]["points"]).reshape(-1, len(off), 3)
    centres = np.asarray(truth["particles"])
    out = []
    for c, p in zip(centres, pts):
        rt, *_ = np.linalg.lstsq(off, p - c, rcond=None)   # off @ R.T = p - c
        out.append(PERM @ rt.T @ PERM)
    return np.asarray(out)


def matrix_to_euler(R):
    """(phi, theta, psi) degrees (..., 3) of R = Rz(psi) Ry(theta) Rz(phi)."""
    R = np.asarray(R, np.float64)
    theta = np.arccos(np.clip(R[..., 2, 2], -1.0, 1.0))
    psi = np.arctan2(R[..., 1, 2], R[..., 0, 2])
    phi = np.arctan2(R[..., 2, 1], -R[..., 2, 0])
    return np.degrees(np.stack([phi, theta, psi], -1))


def euler_to_matrix(eulers):
    e = np.radians(np.asarray(eulers, np.float64))

    def rz(a):
        c, s = np.cos(a), np.sin(a)
        z, o = np.zeros_like(a), np.ones_like(a)
        return np.stack([np.stack([c, -s, z], -1), np.stack([s, c, z], -1),
                         np.stack([z, z, o], -1)], -2)

    def ry(a):
        c, s = np.cos(a), np.sin(a)
        z, o = np.zeros_like(a), np.ones_like(a)
        return np.stack([np.stack([c, z, s], -1), np.stack([z, o, z], -1),
                         np.stack([-s, z, c], -1)], -2)

    return rz(e[..., 2]) @ ry(e[..., 1]) @ rz(e[..., 0])


def _axis_angle(axis, deg):
    a = math.radians(deg)
    x, y, z = axis / np.linalg.norm(axis)
    K = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
    return np.eye(3) + math.sin(a) * K + (1 - math.cos(a)) * K @ K


def orientation_errors_deg(eulers, rotations):
    """Angle (°) of R(eulers)^T R_true per particle."""
    R = euler_to_matrix(eulers)
    tr = np.einsum("pij,pij->p", R, np.asarray(rotations))
    return np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))


def pick_positions(box, binning, thickness, size):
    """Centred unbinned voxel positions (P, 3) (z, y, x) of the bundle's
    picks, as the `csp` mode places them."""
    centre = np.array([thickness / 2, size / 2, size / 2])
    return np.asarray(box, np.float64)[:, :3] * binning - centre


def match_picks(picks, truth, pixel):
    """Index of the nearest planted particle per pick and its distance
    (unbinned px); the planted centres are in Å about the volume centre."""
    planted = np.asarray(truth["particles"], np.float64) / pixel
    d = np.sqrt(((picks[:, None] - planted[None]) ** 2).sum(-1))
    idx = d.argmin(1)
    return idx, d[np.arange(len(picks)), idx]


def matched_picks(picks, truth, pixel):
    """One pick per planted particle: the pick nearest to it, where that
    is within the particle radius (the slab picker also finds texture and
    the tomogram's faces). Returns (pick indices, planted indices)."""
    planted = np.asarray(truth["particles"], np.float64) / pixel
    d = np.sqrt(((picks[:, None] - planted[None]) ** 2).sum(-1))
    near = d.argmin(0)
    keep = d[near, np.arange(len(planted))] <= truth["particle_radius"] / pixel
    return near[keep], np.nonzero(keep)[0]


def start_eulers(rotations, error_deg, seed=0):
    """Eulers (P, 3) of the rotations each turned by error_deg about a
    random axis."""
    rng = np.random.RandomState(seed)
    out = [R @ _axis_angle(rng.randn(3), error_deg) for R in rotations]
    return matrix_to_euler(np.asarray(out)).astype(np.float32)


def write_start(path, eulers):
    """The start table (-csp_parfile): phi, theta, psi per pick."""
    from pyp_tpu_torch.io import cistem

    table = cistem.Table.zeros(len(eulers))
    table["position_in_stack"] = np.arange(1, len(eulers) + 1)
    table["phi"], table["theta"], table["psi"] = np.asarray(eulers).T
    cistem.write_parameters(table, Path(path))
    return Path(path)


def reference(truth, box=CSP_BOX, pixel=1.0, device="cuda"):
    """The CSP reference: the negated particle map (see the module
    docstring), numpy."""
    return -e2e_tomo.particle_map(truth, box, pixel, device).cpu().numpy()


def projected_offsets(picks, xf, angles, sign, truth, size):
    """Distance (px) in every raw tilt between where the bundle's geometry
    puts each pick (the tilt rotation about y, the axis xf[0, 2], the shift
    -sign x xf) and where the matched planted particle is, with the fixture's
    own projection; (T, P)."""
    pixel = truth["pixel"]
    idx, _ = match_picks(picks, truth, pixel)
    planted = np.asarray(truth["particles"])[idx]
    out = []
    for t, theta in enumerate(angles):
        y_p, x_p = e2e_tomo.project_positions(
            planted, float(theta), truth["axis_angle"],
            np.asarray(truth["shifts"])[t], size, pixel)
        y_k, x_k = e2e_tomo.project_positions(
            picks * pixel, float(theta), float(xf[0, 2]),
            sign * np.asarray(xf)[t, :2], size, pixel)
        out.append(np.hypot(y_k - y_p, x_k - x_p))
    return np.asarray(out)


def map_cc(vol, ref, pixel=1.0, lowpass_a=None):
    """Correlation of two maps, optionally both low-passed to lowpass_a."""
    vol, ref = np.asarray(vol, np.float64), np.asarray(ref, np.float64)
    if lowpass_a:
        n = vol.shape[-1]
        k = np.fft.fftfreq(n)
        r = np.sqrt(k[:, None, None] ** 2 + k[None, :, None] ** 2
                    + np.fft.rfftfreq(n)[None, None, :] ** 2)
        keep = r <= pixel / lowpass_a
        vol = np.fft.irfftn(np.fft.rfftn(vol) * keep, s=vol.shape)
        ref = np.fft.irfftn(np.fft.rfftn(ref) * keep, s=ref.shape)
    a, b = vol - vol.mean(), ref - ref.mean()
    return float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))
