"""Particle coordinate files: EMAN .box and PYP .boxx formats.

Equivalent of the reference's inout/utils/pyp_edit_box_files.py
(`produce_box_files`, `produce_boxx_files_fast`): .box rows are
"x y w h" (corner-referenced); .boxx extends with two trailing flags
(inside-micrograph, kept-after-cleaning). Also reads/writes the tomo .spk
3D coordinate format (x y z per row).
"""

from __future__ import annotations

import numpy as np


def write_box(coords_yx, boxsize: int, path):
    """coords (N, 2) center (y, x) -> .box rows 'x_corner y_corner w h'."""
    coords = np.asarray(coords_yx)
    with open(path, "w") as f:
        for y, x in coords[:, :2]:
            f.write(f"{int(x) - boxsize // 2}\t{int(y) - boxsize // 2}\t{boxsize}\t{boxsize}\n")


def read_box(path, boxsize: int | None = None):
    """-> (coords (N, 2) centers (y, x), boxsize)."""
    rows = np.atleast_2d(np.loadtxt(path, ndmin=2))
    if rows.size == 0:
        return np.zeros((0, 2)), boxsize or 0
    w = int(rows[0, 2]) if rows.shape[1] > 2 else (boxsize or 0)
    centers = np.stack([rows[:, 1] + w // 2, rows[:, 0] + w // 2], axis=1)
    return centers, w


def write_boxx(coords_yx, boxsize: int, path, inside=None, kept=None):
    coords = np.asarray(coords_yx)
    n = len(coords)
    inside = np.ones(n, dtype=int) if inside is None else np.asarray(inside, dtype=int)
    kept = np.ones(n, dtype=int) if kept is None else np.asarray(kept, dtype=int)
    with open(path, "w") as f:
        for (y, x), i, k in zip(coords[:, :2], inside, kept):
            f.write(
                f"{int(x) - boxsize // 2}\t{int(y) - boxsize // 2}\t{boxsize}\t{boxsize}\t{int(i)}\t{int(k)}\n"
            )


def read_boxx(path):
    """-> (centers (N, 2) (y, x), boxsize, inside (N,), kept (N,))."""
    rows = np.atleast_2d(np.loadtxt(path, ndmin=2))
    if rows.size == 0:
        return np.zeros((0, 2)), 0, np.zeros(0, int), np.zeros(0, int)
    w = int(rows[0, 2])
    centers = np.stack([rows[:, 1] + w // 2, rows[:, 0] + w // 2], axis=1)
    inside = rows[:, 4].astype(int) if rows.shape[1] > 4 else np.ones(len(rows), int)
    kept = rows[:, 5].astype(int) if rows.shape[1] > 5 else np.ones(len(rows), int)
    return centers, w, inside, kept


def write_spk(coords_zyx, path):
    """3D picks (N, 3) (z, y, x) -> .spk rows 'x y z'."""
    coords = np.asarray(coords_zyx)
    with open(path, "w") as f:
        for z, y, x in coords[:, :3]:
            f.write(f"{x:.1f}\t{y:.1f}\t{z:.1f}\n")


def read_spk(path):
    rows = np.atleast_2d(np.loadtxt(path, ndmin=2))
    if rows.size == 0:
        return np.zeros((0, 3))
    return np.stack([rows[:, 2], rows[:, 1], rows[:, 0]], axis=1)


_CBOX_HEADER = """data_global

_cbox_format_version 1.0

data_cryolo

loop_
_CoordinateX #1
_CoordinateY #2
_CoordinateZ #3
_Width #4
_Height #5
_Depth #6
_EstWidth #7
_EstHeight #8
_Confidence #9
_NumBoxes #10
"""


def write_cbox(coords_xyz, boxsize: float, path, confidence=None):
    """crYOLO .cbox tomogram picks (reference pyp_convert_coord.mod2cryolo,
    analysis/geometry/pyp_convert_coord.py:122): STAR-like header + rows of
    corner coordinates (center - box/2 in x/y, center z) with box extents.
    `coords_xyz` (N, 3) particle CENTERS in (x, y, z)."""
    coords = np.asarray(coords_xyz, dtype=np.float64)
    conf = (np.asarray(confidence, dtype=np.float64)
            if confidence is not None else np.ones(len(coords)))
    with open(path, "w") as f:
        f.write(_CBOX_HEADER)
        for (x, y, z), c in zip(coords[:, :3], conf):
            f.write(f"{x - boxsize / 2:.1f} {y - boxsize / 2:.1f} {z:.1f} "
                    f"{boxsize:.1f} {boxsize:.1f} 1.0 <NA> <NA> "
                    f"{c:.2f} <NA>\n")


def read_cbox(path):
    """crYOLO .cbox -> ((N, 3) particle CENTERS (x, y, z), boxsize,
    (N,) confidences). Corner x/y are shifted back by width/height / 2
    (reference cryolo2mod reads raw columns; centering happens at the
    consumer — folded here so coordinates round-trip)."""
    centers, conf, boxsize = [], [], 0.0
    with open(path) as f:
        for line in f:
            parts = line.split()
            if (line.startswith("_") or line.startswith("data_")
                    or line.startswith("loop_") or len(parts) < 3):
                continue
            x, y, z = (float(parts[0]), float(parts[1]), float(parts[2]))
            w = float(parts[3]) if len(parts) > 3 and parts[3] != "<NA>" \
                else 0.0
            h = float(parts[4]) if len(parts) > 4 and parts[4] != "<NA>" \
                else 0.0
            boxsize = max(boxsize, w, h)
            centers.append([x + w / 2.0, y + h / 2.0, z])
            conf.append(float(parts[8]) if len(parts) > 8
                        and parts[8] != "<NA>" else 1.0)
    if not centers:
        return np.zeros((0, 3)), 0.0, np.zeros(0)
    return np.asarray(centers), boxsize, np.asarray(conf)


def read_coords(path):
    """Extension-dispatched 3D coordinate reader -> (N, 3) float32 rows
    (z, y, x) — the tomo_pick files-import card accepts any supported pick
    format (.spk/.cbox/.box/.mod/.next)."""
    p = str(path)
    if p.endswith(".spk"):
        return np.asarray(read_spk(p), dtype=np.float32)
    if p.endswith(".cbox"):
        centers_xyz, _box, _conf = read_cbox(p)
        c = np.asarray(centers_xyz, dtype=np.float32)
        return c[:, ::-1]  # (x, y, z) -> (z, y, x)
    if p.endswith(".mod"):
        from pyp_tpu_torch.io.imod import read_model

        pts = np.asarray(read_model(p), dtype=np.float32)  # (N, 3) x,y,z
        return pts[:, ::-1]
    if p.endswith(".box"):
        rows = np.asarray(read_box(p), dtype=np.float32)   # (N, 2) (y, x)
        return np.concatenate(
            [np.zeros((len(rows), 1), np.float32), rows[:, :2]], axis=1)
    rows = np.atleast_2d(np.loadtxt(p, ndmin=2)).astype(np.float32)
    return rows[:, :3]
