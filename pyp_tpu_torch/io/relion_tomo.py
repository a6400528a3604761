"""The ArtiaX per-tilt-series particle star — the port's copy of
`export_artiax_star` of pyp_tpu/io/relion_tomo.py (the rest of that
module, the RELION tomogram and particle star interop, is not ported).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _loop_header(block: str, cols) -> str:
    lines = [f"data_{block}", "", "loop_"]
    lines += [f"{c} #{i + 1}" for i, c in enumerate(cols)]
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# ArtiaX per-tilt-series star (ChimeraX mapped-back visualization)
# ---------------------------------------------------------------------------

_ARTIAX_COLS = (
    "_rlnTomoName", "_rlnCoordinateX", "_rlnCoordinateY", "_rlnCoordinateZ",
    "_rlnAngleRot", "_rlnAngleTilt", "_rlnAnglePsi",
    "_rlnOriginXAngst", "_rlnOriginYAngst", "_rlnOriginZAngst",
    "_rlnLogLikeliContribution", "_rlnClassNumber",
)


def export_artiax_star(name, positions, eulers, rec_shape, rec_binning,
                       path, scores=None, classes=None, shifts_angst=None):
    """Per-tilt-series particle star for ArtiaX/ChimeraX display.

    The reference writes these "ministar" files per series during the CSPT
    merge (generate_ministar, inout/metadata/core.py:3139; consumed per
    docs/guide/chimerax_artiax.rst: open the .rec, then the matching .star
    as an ArtiaX particle list). Coordinates land in the display
    tomogram's voxel frame (corner origin, z flipped to match the .rec
    orientation).

    positions: (P, 3) (z, y, x) CENTERED voxels in the CSP working frame
        (rec_binning working voxels per .rec voxel).
    eulers: (P, 3) (phi, theta, psi) degrees, PYP ZYZ (maps 1:1 to RELION
        rot/tilt/psi — io/relion.py convention note).
    rec_shape: (nz, ny, nx) of the display .rec volume.
    """
    pos = np.asarray(positions, dtype=np.float64)
    eul = np.asarray(eulers, dtype=np.float64)
    n = len(pos)
    nz, ny, nx = (int(v) for v in rec_shape)
    b = float(rec_binning)
    cx = pos[:, 2] / b + nx / 2.0
    cy = pos[:, 1] / b + ny / 2.0
    cz = nz - (pos[:, 0] / b + nz / 2.0)  # z flip (reference ministar)
    sc = (np.asarray(scores, dtype=np.float64) if scores is not None
          else np.zeros(n))
    cl = (np.asarray(classes, dtype=np.int64) if classes is not None
          else np.ones(n, dtype=np.int64))
    sh = (np.asarray(shifts_angst, dtype=np.float64)
          if shifts_angst is not None else np.zeros((n, 3)))
    lines = ["", "# version 30001", "", _loop_header("particles", _ARTIAX_COLS)]
    rows = []
    for p in range(n):
        rows.append("\t".join(map(str, [
            name, round(cx[p], 3), round(cy[p], 3), round(cz[p], 3),
            round(eul[p, 0], 3), round(eul[p, 1], 3), round(eul[p, 2], 3),
            round(sh[p, 0], 3), round(sh[p, 1], 3), round(sh[p, 2], 3),
            round(sc[p], 6), int(cl[p])])))
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text("\n".join(lines) + "\n".join(rows) + "\n")
    return path
