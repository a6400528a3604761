"""Plain scores that judge the tilt-series parameters a run chose.

`csp_scores`: the CTF-weighted normalised cross-correlation of every (tilt,
particle) window with the true volume's central slice under constrained
parameters (tilt geometry, per-tilt shifts, particle orientations and
positions), over the band's points, averaged per series. The truth scores
highest up to noise, so the gap between the truth's score and the refined
parameters' says how far the refinement fell short.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import fourier as rf



def tilt_rotations(tilt_deg, axis_deg):
    """R_t = Rz(axis) Ry(tilt): tomogram to image frame."""
    return rf.rot(axis_deg, "z") @ rf.rot(tilt_deg, "y")


def csp_geometry(tilt, axis, shifts, eulers, pos):
    """For parameters with a leading series axis: R_eff (S, T, P, 3, 3),
    image positions (S, T, P, 2) = (y, x), depth (S, T, P) in voxels.
    pos is (S, P, 3) = (z, y, x) about the tomogram centre; shifts (S, T, 2)
    (y, x) pixels."""
    Rt = tilt_rotations(tilt, axis)                          # (S, T, 3, 3)
    M = rf.euler_to_matrix(eulers[..., 0], eulers[..., 1], eulers[..., 2])
    R_eff = Rt[:, :, None] @ M[:, None]                      # (S, T, P, 3, 3)
    xyz = (Rt[:, :, None] @ pos.flip(-1)[:, None, :, :, None])[..., 0]
    proj = xyz[..., :2].flip(-1) + shifts[:, :, None, :]
    return R_eff, proj, xyz[..., 2]


def csp_scores(xv, pts, centres, tilt_df, params, Fvol, n, pixel,
               chunk=2):
    """(S,) mean correlation of every projection of each series: window
    samples xv (S, T, P, G) at band points pts (G, 2), window centres
    (S, T, P, 2), per-tilt defocus tilt_df (S, T) Å, params a dict of
    tilt, axis, shifts, eulers, pos, df_offsets (S, T)."""
    dt = Fvol.real.dtype
    out = []
    for lo in range(0, xv.shape[0], chunk):
        sl = slice(lo, lo + chunk)
        g = {k: v[sl].to(dt) for k, v in params.items()}
        R_eff, proj, depth = csp_geometry(g["tilt"], g["axis"], g["shifts"],
                                          g["eulers"], g["pos"])
        q = (pts[:, 1, None] * R_eff[..., None, 0, :]
             + pts[:, 0, None] * R_eff[..., None, 1, :]).flip(-1)
        u = rf.gather_3d(Fvol, q, scale=float(Fvol.shape[0] // n))
        df = (tilt_df[sl].to(dt)[..., None] + g["df_offsets"][..., None]
              + depth * pixel)[..., None]
        c = rf.ctf(pts, n, pixel, df, df, 0.0)
        d = proj - centres[sl].to(dt)
        ph = (-2.0 * math.pi / n) * (pts[:, 0] * d[..., 0:1] + pts[:, 1] * d[..., 1:2])
        x = xv[sl].to(u.dtype)
        num = (c * (x.conj() * u * torch.polar(torch.ones_like(ph), ph)).real).sum(-1)
        den = torch.sqrt((x.abs() ** 2).sum(-1) * (c * c * u.abs() ** 2).sum(-1))
        out.append((num / den.clamp(min=1e-30)).mean((-2, -1)))
    return torch.cat(out)
