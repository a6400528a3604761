"""IMOD binary model (.mod) codec — point/contour models.

The reference shells out to IMOD's model2point/point2model binaries for
manual-picking interop (pyp_edit_box_files.py:534, metadata/core.py:2465);
here the format is decoded natively. Layout (big-endian, IMOD binary model
spec): 8-byte magic "IMODV1.2", 232-byte model header, then tagged chunks —
OBJT (176 bytes: name[64], contsize at +64, colors), CONT (16-byte header +
psize * 3 float32 xyz points), and generic (tag + int32 length + payload)
chunks (IMAT/VIEW/MINX/...), terminated by IEOF. Validated against a model
written by IMOD itself (tests/golden/ref_imod.mod)."""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_MAGIC = b"IMODV1.2"
_HEADER = struct.Struct(">128s 4i I 4i 6f 5i f i i 3f")  # 232 bytes
_OBJT_SIZE = 176
_CONT_HEAD = struct.Struct(">i I i i")


def read_model(path):
    """Parse a .mod file: returns (objects, header dict). `objects` is a
    list of objects; each object is a list of contours, each an (P, 3)
    float32 array of (x, y, z) points."""
    data = Path(path).read_bytes()
    if data[:8] != _MAGIC[:5] + data[5:8]:  # accept IMODV1.x
        if not data[:5] == b"IMODV":
            raise ValueError(f"not an IMOD model: {data[:8]!r}")
    fields = _HEADER.unpack(data[8:8 + _HEADER.size])
    header = {
        "name": fields[0].split(b"\0")[0].decode("latin1"),
        "xmax": fields[1], "ymax": fields[2], "zmax": fields[3],
        "objsize": fields[4], "pixsize": fields[20], "units": fields[21],
    }
    off = 8 + _HEADER.size
    objects = []
    cur = None
    while off + 4 <= len(data):
        tag = data[off:off + 4]
        off += 4
        if tag == b"OBJT":
            (contsize,) = struct.unpack(">i", data[off + 64:off + 68])
            cur = []
            objects.append(cur)
            off += _OBJT_SIZE
        elif tag == b"CONT":
            psize, _flags, _time, _surf = _CONT_HEAD.unpack(
                data[off:off + 16])
            pts = np.frombuffer(
                data[off + 16:off + 16 + psize * 12],
                dtype=">f4").reshape(psize, 3).astype(np.float32)
            if cur is None:
                cur = []
                objects.append(cur)
            cur.append(pts)
            off += 16 + psize * 12
        elif tag == b"IEOF":
            break
        else:  # generic chunk: int32 byte length follows the tag
            (ln,) = struct.unpack(">i", data[off:off + 4])
            off += 4 + ln
    return objects, header


def read_points(path):
    """All points of all objects/contours as one (N, 3) array (x, y, z) —
    the model2point role."""
    objects, _ = read_model(path)
    conts = [c for obj in objects for c in obj]
    if not conts:
        return np.zeros((0, 3), dtype=np.float32)
    return np.concatenate(conts, axis=0)


def write_point_model(path, points, shape_xyz=None, name="pyp_tpu",
                      pixsize: float = 1.0, point_size: int = 10,
                      color=(1.0, 0.0, 0.0)):
    """Write a scattered-point model (the point2model -zero -scat role):
    one object, one contour per point. points: (N, 3) (x, y, z)."""
    points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    if shape_xyz is None:
        mx = points.max(axis=0) if len(points) else np.ones(3)
        shape_xyz = tuple(int(np.ceil(m)) + 1 for m in mx)
    out = bytearray()
    out += _MAGIC
    out += _HEADER.pack(
        name.encode("latin1")[:128], int(shape_xyz[0]), int(shape_xyz[1]),
        int(shape_xyz[2]), 1,               # objsize
        0x0C00, 1, 0, 0, 255,               # flags, drawmode, mouse, bw
        0.0, 0.0, 0.0, 1.0, 1.0, 1.0,       # offsets, scales
        0, 0, 0, 3, 128,                    # cur obj/cont/pt, res, thresh
        float(pixsize), 0, 0,               # pixsize, units, csum
        0.0, 0.0, 0.0,
    )
    # OBJT: name[64] @0, contsize @64, flags @68 (scattered|open), axis @72,
    # drawmode @76, rgb @80, pdrawsize @92, style bytes @96, mesh/surf @104
    objt = bytearray(_OBJT_SIZE)
    objt[0:64] = name.encode("latin1")[:63].ljust(64, b"\0")
    struct.pack_into(">i", objt, 64, len(points))          # contsize
    struct.pack_into(">I", objt, 68, 0x8 | 0x200)          # open | scattered
    struct.pack_into(">i", objt, 76, 1)                    # drawmode
    struct.pack_into(">3f", objt, 80, *color)
    struct.pack_into(">i", objt, 92, int(point_size))      # pdrawsize
    out += b"OBJT" + objt
    for p in points:
        out += b"CONT" + _CONT_HEAD.pack(1, 0, 0, 0)
        out += struct.pack(">3f", float(p[0]), float(p[1]), float(p[2]))
    out += b"IEOF"
    Path(path).write_bytes(bytes(out))
    return Path(path)


def read_xf(path):
    """IMOD .xf transform file (6 columns per tilt: a11 a12 a21 a22 dx dy;
    the etomo/AreTomo interchange format) -> (shifts (T, 2) as (dy, dx),
    rotation_deg (T,)). Rotation is recovered from the linear part
    (atan2(a21, a11)); IMOD dx/dy are x-then-y, internal order is (y, x)."""
    rows = []
    for line in Path(path).read_text().splitlines():
        parts = line.split()
        if len(parts) >= 6:
            rows.append([float(v) for v in parts[:6]])
    if not rows:
        raise ValueError(f"no transforms in {path}")
    a = np.asarray(rows, dtype=np.float64)
    rot = np.degrees(np.arctan2(a[:, 2], a[:, 0]))
    shifts = np.stack([a[:, 5], a[:, 4]], axis=1)  # (dy, dx)
    return shifts.astype(np.float32), rot.astype(np.float32)


def write_xf(path, shifts, rotation_deg=None):
    """Inverse of read_xf: write IMOD 6-column transforms."""
    shifts = np.asarray(shifts, dtype=np.float64)
    T = shifts.shape[0]
    rot = np.zeros(T) if rotation_deg is None else np.asarray(
        rotation_deg, dtype=np.float64).reshape(-1)
    lines = []
    for t in range(T):
        c, s = np.cos(np.radians(rot[t])), np.sin(np.radians(rot[t]))
        lines.append(f"{c:12.7f}{-s:12.7f}{s:12.7f}{c:12.7f}"
                     f"{shifts[t, 1]:12.3f}{shifts[t, 0]:12.3f}")
    Path(path).write_text("\n".join(lines) + "\n")
    return Path(path)
