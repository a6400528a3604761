"""Euler-angle conventions and rotation utilities (FREALIGN/cisTEM ZYZ) —
the torch port of pyp_tpu/core/geometry.py.

A particle orientation is (phi, theta, psi) in degrees with rotation matrix

    R(phi, theta, psi) = Rz(psi) @ Ry(theta) @ Rz(phi)

mapping reference-volume coordinates to particle-image coordinates; the
image spectrum lives on the plane spanned by rows 0, 1 of R. Point-group
matrices are host-side numpy constants.
"""

from __future__ import annotations

import numpy as np
import torch


def _as_angle(a, like=None):
    if isinstance(a, torch.Tensor):
        return a if a.is_floating_point() else a.to(torch.float32)
    device = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def _rot(angle_deg, axis: str):
    a = torch.deg2rad(_as_angle(angle_deg))
    c, s = torch.cos(a), torch.sin(a)
    z = torch.zeros_like(c)
    o = torch.ones_like(c)
    if axis == "z":
        rows = [[c, -s, z], [s, c, z], [z, z, o]]
    else:  # y
        rows = [[c, z, s], [z, o, z], [-s, z, c]]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def rot_z(angle_deg):
    return _rot(angle_deg, "z")


def rot_y(angle_deg):
    return _rot(angle_deg, "y")


def rot_x(angle_deg):
    a = torch.deg2rad(_as_angle(angle_deg))
    c, s = torch.cos(a), torch.sin(a)
    z = torch.zeros_like(c)
    o = torch.ones_like(c)
    rows = [[o, z, z], [z, c, -s], [z, s, c]]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def euler_to_matrix(phi, theta, psi):
    """ZYZ Euler angles (degrees; tensors or numbers, broadcastable) ->
    rotation matrix (..., 3, 3). Differentiable in the angles."""
    ref = next((a for a in (phi, theta, psi) if isinstance(a, torch.Tensor)),
               None)
    phi, theta, psi = (_as_angle(a, ref) for a in (phi, theta, psi))
    phi, theta, psi = torch.broadcast_tensors(phi, theta, psi)
    return rot_z(psi) @ rot_y(theta) @ rot_z(phi)


def matrix_to_euler(R):
    """Rotation matrix (..., 3, 3) -> (phi, theta, psi) degrees, ZYZ.
    Inverse of euler_to_matrix up to gimbal ambiguity at theta in {0, 180}."""
    eps = 1e-7
    r22 = torch.clamp(R[..., 2, 2], -1.0, 1.0)
    theta = torch.arccos(r22)
    degenerate = torch.abs(r22) > 1.0 - eps
    psi_g = torch.atan2(R[..., 1, 2], R[..., 0, 2])
    phi_g = torch.atan2(R[..., 2, 1], -R[..., 2, 0])
    # theta ~ 0: R = Rz(psi + phi); put all rotation in phi
    phi_d = torch.atan2(R[..., 1, 0], R[..., 0, 0]) * torch.sign(r22)
    phi = torch.where(degenerate, phi_d, phi_g)
    psi = torch.where(degenerate, torch.zeros_like(psi_g), psi_g)
    r2d = 180.0 / np.pi
    return phi * r2d, theta * r2d, psi * r2d



def euler_zxz_to_zyz(z1, x, z2):
    """ZXZ Euler angles (3DAVG/EMAN2 style, degrees) -> the ZYZ triplet
    (phi, theta, psi) of the same rotation, as tensors."""
    ref = next((a for a in (z1, x, z2) if isinstance(a, torch.Tensor)), None)
    z1, x, z2 = (_as_angle(a, ref) for a in (z1, x, z2))
    return matrix_to_euler(rot_z(z1) @ rot_x(x) @ rot_z(z2))


def angular_grid(angular_step_deg: float, psi_step_deg: float | None = None,
                 theta_max_deg: float = 180.0):
    """Quasi-uniform global search grid over SO(3): projection directions
    (theta, phi) on latitude rings with longitude spacing scaled by
    1/sin(theta), psi sampled uniformly. Returns an (N, 3) float32 numpy
    array of (phi, theta, psi) in degrees."""
    if psi_step_deg is None:
        psi_step_deg = angular_step_deg
    thetas = np.arange(0.0, theta_max_deg + 1e-6, angular_step_deg)
    dirs = []
    for t in thetas:
        st = np.sin(np.radians(max(t, 1e-3)))
        n_phi = max(1, int(round(360.0 * st / angular_step_deg)))
        if t in (0.0, 180.0):
            n_phi = 1
        for p in np.arange(n_phi) * (360.0 / n_phi):
            dirs.append((p, t))
    psis = np.arange(0.0, 360.0, psi_step_deg)
    return np.array([(phi, th, ps) for (phi, th) in dirs for ps in psis],
                    dtype=np.float32)

# ---------------------------------------------------------------------------
# point groups (host-side numpy; copied from pyp_tpu/core/geometry.py
# because that module imports jax)
# ---------------------------------------------------------------------------

def normal_to_euler(nx, ny, nz):
    """Euler angles (phi, theta, psi) in degrees that carry the reference
    z-axis onto the given (unit) normal under the projection convention:
    the reference +z appears at polar angle theta from the beam with
    azimuth psi; phi spins the reference about its own z first and does
    not move the axis, so it is returned as 0 (the free in-plane
    parameter of an axis prior). Components are tensors, arrays or
    numbers; the angles are float32 tensors on the components' device."""
    ref = next((a for a in (nx, ny, nz) if isinstance(a, torch.Tensor)),
               None)
    nx, ny, nz = (_as_angle(a, ref) for a in (nx, ny, nz))
    theta = torch.rad2deg(torch.arccos(torch.clamp(nz, -1.0, 1.0)))
    psi = torch.rad2deg(torch.atan2(ny, nx))
    return torch.zeros_like(psi), theta, psi


def apply_symmetry_matrices(symmetry: str) -> np.ndarray:
    """Rotation matrices of a point group: Cn, Dn, T, O, I (I = 60
    rotations generated by closure)."""
    sym = symmetry.upper().strip()
    mats = [np.eye(3)]
    if sym.startswith("C") and sym[1:].isdigit():
        n = int(sym[1:])
        mats = [_rz_np(360.0 * k / n) for k in range(n)]
    elif sym.startswith("D") and sym[1:].isdigit():
        n = int(sym[1:])
        cz = [_rz_np(360.0 * k / n) for k in range(n)]
        flip = _rx_np(180.0)
        mats = cz + [m @ flip for m in cz]
    elif sym == "T":
        mats = _closure([_rz_np(180.0), _ry_np(180.0),
                         _axis_rot([1, 1, 1], 120.0)], 12)
    elif sym == "O":
        mats = _closure([_rz_np(90.0), _ry_np(90.0)], 24)
    elif sym.startswith("I"):
        # 2-fold axes on x/y/z, 5-fold through vertex (0, 1, golden ratio)
        phi = (1 + np.sqrt(5)) / 2
        mats = _closure([_axis_rot([0, 0, 1], 180.0),
                         _axis_rot([0, 1, phi], 72.0)], 120)
    return np.stack(mats).astype(np.float32)


def _rz_np(a):
    a = np.radians(a)
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])


def _rx_np(a):
    a = np.radians(a)
    c, s = np.cos(a), np.sin(a)
    return np.array([[1.0, 0, 0], [0, c, -s], [0, s, c]])


def _ry_np(a):
    a = np.radians(a)
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1.0, 0], [-s, 0, c]])


def _closure(gens, max_n):
    """Generate a finite rotation group from generators by closure."""
    mats = [np.eye(3)]

    def key(m):
        return tuple(np.round(m.flatten(), 5))

    seen = {key(np.eye(3))}
    frontier = [np.eye(3)]
    while frontier and len(mats) < max_n:
        new_frontier = []
        for m in frontier:
            for g in gens:
                c = g @ m
                k = key(c)
                if k not in seen:
                    seen.add(k)
                    mats.append(c)
                    new_frontier.append(c)
        frontier = new_frontier
    return mats


def _axis_rot(axis, angle_deg):
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    a = np.radians(angle_deg)
    c, s = np.cos(a), np.sin(a)
    x, y, z = axis
    K = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
    return np.eye(3) * c + s * K + (1 - c) * np.outer(axis, axis)


# CSP patch regions (host-side numpy; copied from pyp_tpu/core/geometry.py)

def divide_regions(bounds_min, bounds_max, grid):
    """Partition a 2D/3D bounding box into a regular grid of patches; returns
    per-region (lo, hi) corners. Equivalent of the reference's
    divide2regions (analysis/geometry/core.py:554) used for CSP patch
    refinement."""
    bounds_min = np.asarray(bounds_min, dtype=np.float64)
    bounds_max = np.asarray(bounds_max, dtype=np.float64)
    grid = np.asarray(grid, dtype=np.int64)
    steps = (bounds_max - bounds_min) / grid
    regions = []
    for idx in np.ndindex(*grid):
        lo = bounds_min + steps * np.asarray(idx)
        hi = lo + steps
        regions.append((lo, hi))
    return regions


def region_of(points, bounds_min, bounds_max, grid):
    """Assign each point (N, D) to its region index in the regular grid."""
    points = np.asarray(points, dtype=np.float64)
    bounds_min = np.asarray(bounds_min)
    bounds_max = np.asarray(bounds_max)
    grid = np.asarray(grid, dtype=np.int64)
    steps = (bounds_max - bounds_min) / grid
    idx = np.clip(((points - bounds_min) / steps).astype(np.int64), 0, grid - 1)
    flat = np.zeros(len(points), dtype=np.int64)
    for d in range(points.shape[1]):
        flat = flat * grid[d] + idx[:, d]
    return flat


def relion_tomo_projection_matrix(tilt_angle_deg, xf, thickness,
                                  image_dims, tomo_x, tomo_y):
    """Per-tilt 4x4 projection matrix (float64 numpy) in RELION's
    tomogram convention: the IMOD-style alignment transform composed with
    the single-axis tilt projection and RELION's yz-flipped tomogram frame,
    the matrix tomograms.star carries in its `_rlnTomoProj{X,Y,Z,W}` rows.

    tilt_angle_deg: stage tilt; xf: IMOD 6-element affine row
    (a11, a12, a21, a22, dx, dy); thickness: unbinned tomogram Z;
    image_dims: raw image (x, y); tomo_x/tomo_y: unbinned tomogram dims.
    """
    t = np.radians(float(tilt_angle_deg))
    ocx = (image_dims[0] - 1.0) / 2.0
    ocy = (image_dims[1] - 1.0) / 2.0
    acx = (tomo_x - 1.0) / 2.0
    acy = (tomo_y - 1.0) / 2.0

    def m4(rows):
        return np.asarray(rows, dtype=np.float64)

    # RELION tomogram frame: y <- thickness-1-z, z <- y
    yzflip = m4([[1, 0, 0, 0], [0, 0, -1, thickness - 1],
                 [0, 1, 0, 0], [0, 0, 0, 1]])
    to_imod_origin = m4([[1, 0, 0, -1], [0, 1, 0, -thickness / 2.0],
                         [0, 0, 1, -1], [0, 0, 0, 1]])
    # single-axis projection about y (IMOD tilt geometry), recentred on the
    # aligned stack's centre
    tilt_m = m4([[np.cos(t), -np.sin(t), 0, acx], [0, 0, 1, acy],
                 [-np.sin(t), -np.cos(t), 0, 0], [0, 0, 0, 1]])
    to_origin = m4([[1, 0, 0, -acx], [0, 1, 0, 0],
                    [0, 0, 1, -acy], [0, 0, 0, 1]])
    xf_m = m4([[xf[0], xf[1], 0, xf[4]], [xf[2], xf[3], 0, xf[5]],
               [0, 0, 1, 0], [0, 0, 0, 1]])
    p = m4([[1, 0, 0, ocx], [0, 1, 0, ocy], [0, 0, 1, 0], [0, 0, 0, 1]])
    q = m4([[1, 0, 0, -acx], [0, 1, 0, -acy], [0, 0, 1, 0], [0, 0, 0, 1]])
    affine = p @ np.linalg.inv(xf_m) @ q
    return affine @ tilt_m @ to_origin @ to_imod_origin @ yzflip
