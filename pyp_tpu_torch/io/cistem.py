"""cisTEM binary parameter file (.cistem) codec, including PYP extended blocks.

Format (reverse-spec'd from the reference's reader/writer,
src/pyp/inout/metadata/cistem_star_file.py:93-187 and the
public cisTEM2 sources it cites): little-endian; header = num_columns:int32,
num_rows:int32; then per-column descriptors (column_id:int64 bitmask,
type_code:int8); then row-major binary records. The "extended" file holds two
blocks (particles keyed by PIND, tilts keyed by TIND), each prefixed by an
int64 block id.

This module keeps the on-disk layout byte-compatible with the reference so
outputs can be regression-compared, while exposing the data as a plain
{column_name: np.ndarray} table.

The port's own copy of pyp_tpu/io/cistem.py; keep the two in step.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

# ---------------------------------------------------------------------------
# column ids (bitmask values from cisTEM's cistem_parameters.h, public)
# ---------------------------------------------------------------------------
POSITION_IN_STACK = 1
IMAGE_IS_ACTIVE = 2
PSI = 4
X_SHIFT = 8
Y_SHIFT = 16
DEFOCUS_1 = 32
DEFOCUS_2 = 64
DEFOCUS_ANGLE = 128
PHASE_SHIFT = 256
OCCUPANCY = 512
LOGP = 1024
SIGMA = 2048
SCORE = 4096
SCORE_CHANGE = 8192
PIXEL_SIZE = 16384
MICROSCOPE_VOLTAGE = 32768
MICROSCOPE_CS = 65536
AMPLITUDE_CONTRAST = 131072
BEAM_TILT_X = 262144
BEAM_TILT_Y = 524288
IMAGE_SHIFT_X = 1048576
IMAGE_SHIFT_Y = 2097152
THETA = 4194304
PHI = 8388608
STACK_FILENAME = 16777216
ORIGINAL_IMAGE_FILENAME = 33554432
REFERENCE_3D_FILENAME = 67108864
BEST_2D_CLASS = 134217728
BEAM_TILT_GROUP = 268435456
PARTICLE_GROUP = 536870912
PRE_EXPOSURE = 1073741824
TOTAL_EXPOSURE = 2147483648
ASSIGNED_SUBSET = 4294967296
ORIGINAL_X_POSITION = 8589934592
ORIGINAL_Y_POSITION = 17179869184

# PYP extension ids (index columns + per-particle / per-tilt / per-frame blocks)
IMIND = 20
PIND = 15
TIND = 35
RIND = 70
FIND = 55
PSHIFT_X = 3
PSHIFT_Y = 9
PSHIFT_Z = 27
PPSI = 81
PTHETA = 273
PPHI = 819
ORIGINAL_X_POSITION_3D = 2457
ORIGINAL_Y_POSITION_3D = 7371
ORIGINAL_Z_POSITION_3D = 22113
PSCORE = 66339
POCC = 199017
TSHIFT_X = 7
TSHIFT_Y = 49
TILTANG = 343
TILTAXIS = 2401
FSHIFT_X = 11
FSHIFT_Y = 121

# type codes (cistem2 defines.h, public)
T_TEXT, T_INTEGER, T_FLOAT, T_BOOL, T_LONG, T_DOUBLE, T_CHAR = 1, 2, 3, 4, 5, 6, 7
T_VARIABLE_LENGTH, T_INTEGER_UNSIGNED = 8, 9

_TYPE_NP = {
    T_INTEGER: np.dtype("<i4"),
    T_FLOAT: np.dtype("<f4"),
    T_LONG: np.dtype("<i8"),
    T_CHAR: np.dtype("<i1"),
    T_INTEGER_UNSIGNED: np.dtype("<u4"),
}

# column id -> (canonical name, type code)
COLUMNS = {
    POSITION_IN_STACK: ("position_in_stack", T_INTEGER_UNSIGNED),
    IMAGE_IS_ACTIVE: ("image_is_active", T_INTEGER),
    PSI: ("psi", T_FLOAT),
    THETA: ("theta", T_FLOAT),
    PHI: ("phi", T_FLOAT),
    X_SHIFT: ("x_shift", T_FLOAT),
    Y_SHIFT: ("y_shift", T_FLOAT),
    DEFOCUS_1: ("defocus_1", T_FLOAT),
    DEFOCUS_2: ("defocus_2", T_FLOAT),
    DEFOCUS_ANGLE: ("defocus_angle", T_FLOAT),
    PHASE_SHIFT: ("phase_shift", T_FLOAT),
    OCCUPANCY: ("occupancy", T_FLOAT),
    LOGP: ("logp", T_FLOAT),
    SIGMA: ("sigma", T_FLOAT),
    SCORE: ("score", T_FLOAT),
    SCORE_CHANGE: ("score_change", T_FLOAT),
    PIXEL_SIZE: ("pixel_size", T_FLOAT),
    MICROSCOPE_VOLTAGE: ("microscope_voltage", T_FLOAT),
    MICROSCOPE_CS: ("microscope_cs", T_FLOAT),
    AMPLITUDE_CONTRAST: ("amplitude_contrast", T_FLOAT),
    BEAM_TILT_X: ("beam_tilt_x", T_FLOAT),
    BEAM_TILT_Y: ("beam_tilt_y", T_FLOAT),
    IMAGE_SHIFT_X: ("image_shift_x", T_FLOAT),
    IMAGE_SHIFT_Y: ("image_shift_y", T_FLOAT),
    BEST_2D_CLASS: ("best_2d_class", T_INTEGER),
    BEAM_TILT_GROUP: ("beam_tilt_group", T_INTEGER),
    PARTICLE_GROUP: ("particle_group", T_INTEGER),
    ASSIGNED_SUBSET: ("assigned_subset", T_INTEGER),
    PRE_EXPOSURE: ("pre_exposure", T_FLOAT),
    TOTAL_EXPOSURE: ("total_exposure", T_FLOAT),
    ORIGINAL_X_POSITION: ("original_x_position", T_FLOAT),
    ORIGINAL_Y_POSITION: ("original_y_position", T_FLOAT),
    IMIND: ("image_index", T_INTEGER),
    PIND: ("particle_index", T_INTEGER),
    TIND: ("tilt_index", T_INTEGER),
    RIND: ("region_index", T_INTEGER),
    FIND: ("frame_index", T_INTEGER),
    PSHIFT_X: ("shift_x", T_FLOAT),
    PSHIFT_Y: ("shift_y", T_FLOAT),
    PSHIFT_Z: ("shift_z", T_FLOAT),
    PPSI: ("ppsi", T_FLOAT),
    PTHETA: ("ptheta", T_FLOAT),
    PPHI: ("pphi", T_FLOAT),
    ORIGINAL_X_POSITION_3D: ("x_position_3d", T_FLOAT),
    ORIGINAL_Y_POSITION_3D: ("y_position_3d", T_FLOAT),
    ORIGINAL_Z_POSITION_3D: ("z_position_3d", T_FLOAT),
    PSCORE: ("pscore", T_FLOAT),
    POCC: ("pocc", T_FLOAT),
    TSHIFT_X: ("tshift_x", T_FLOAT),
    TSHIFT_Y: ("tshift_y", T_FLOAT),
    TILTANG: ("tilt_angle", T_FLOAT),
    TILTAXIS: ("tilt_axis", T_FLOAT),
    FSHIFT_X: ("fshift_x", T_FLOAT),
    FSHIFT_Y: ("fshift_y", T_FLOAT),
}
NAME_TO_ID = {name: cid for cid, (name, _) in COLUMNS.items()}

# The standard per-projection column set PYP writes for refine3d-style input
# (order matters for byte compatibility; matches the reference's to_binary)
DEFAULT_PROJECTION_COLUMNS = [
    POSITION_IN_STACK, IMAGE_IS_ACTIVE, PSI, THETA, PHI, X_SHIFT, Y_SHIFT,
    DEFOCUS_1, DEFOCUS_2, DEFOCUS_ANGLE, PHASE_SHIFT, OCCUPANCY, LOGP, SIGMA,
    SCORE, SCORE_CHANGE, PIXEL_SIZE, MICROSCOPE_VOLTAGE, MICROSCOPE_CS,
    AMPLITUDE_CONTRAST, BEAM_TILT_X, BEAM_TILT_Y, IMAGE_SHIFT_X, IMAGE_SHIFT_Y,
    BEST_2D_CLASS, BEAM_TILT_GROUP, PARTICLE_GROUP, ASSIGNED_SUBSET,
    PRE_EXPOSURE, TOTAL_EXPOSURE, ORIGINAL_X_POSITION, ORIGINAL_Y_POSITION,
    IMIND, PIND, TIND, RIND, FIND,
]

PARTICLE_BLOCK_COLUMNS = [
    PIND, PSHIFT_X, PSHIFT_Y, PSHIFT_Z, PPSI, PTHETA, PPHI,
    ORIGINAL_X_POSITION_3D, ORIGINAL_Y_POSITION_3D, ORIGINAL_Z_POSITION_3D,
    PSCORE, POCC,
]
TILT_BLOCK_COLUMNS = [TIND, RIND, TSHIFT_X, TSHIFT_Y, TILTANG, TILTAXIS]


@dataclass
class Table:
    """A typed column table backed by 1-D numpy arrays, in declared order."""

    column_ids: list = field(default_factory=list)
    data: dict = field(default_factory=dict)  # name -> np.ndarray

    @property
    def n_rows(self) -> int:
        if not self.data:
            return 0
        return len(next(iter(self.data.values())))

    def __getitem__(self, name):
        return self.data[name]

    def __setitem__(self, name, value):
        if name not in NAME_TO_ID:
            raise KeyError(name)
        cid = NAME_TO_ID[name]
        if cid not in self.column_ids:
            self.column_ids.append(cid)
        arr = np.asarray(value)
        self.data[name] = arr.astype(_TYPE_NP[COLUMNS[cid][1]])

    def __contains__(self, name):
        return name in self.data

    @classmethod
    def zeros(cls, n_rows: int, column_ids=None) -> "Table":
        column_ids = list(column_ids or DEFAULT_PROJECTION_COLUMNS)
        t = cls(column_ids=column_ids)
        for cid in column_ids:
            name, tc = COLUMNS[cid]
            t.data[name] = np.zeros(n_rows, dtype=_TYPE_NP[tc])
        return t

    def to_records(self) -> np.ndarray:
        dtype = np.dtype(
            [(COLUMNS[cid][0], _TYPE_NP[COLUMNS[cid][1]]) for cid in self.column_ids]
        )
        rec = np.empty(self.n_rows, dtype=dtype)
        for cid in self.column_ids:
            name = COLUMNS[cid][0]
            rec[name] = self.data[name]
        return rec

    def select(self, mask) -> "Table":
        out = Table(column_ids=list(self.column_ids))
        out.data = {k: v[mask] for k, v in self.data.items()}
        return out

    def copy(self) -> "Table":
        out = Table(column_ids=list(self.column_ids))
        out.data = {k: v.copy() for k, v in self.data.items()}
        return out


def _write_block(f, table: Table):
    f.write(struct.pack("<ii", len(table.column_ids), table.n_rows))
    for cid in table.column_ids:
        f.write(struct.pack("<qb", cid, COLUMNS[cid][1]))
    f.write(table.to_records().tobytes())


def _read_block(f) -> Table:
    ncol, nrow = struct.unpack("<ii", f.read(8))
    cids, fields = [], []
    for _ in range(ncol):
        cid, tc = struct.unpack("<qb", f.read(9))
        if cid not in COLUMNS:
            raise ValueError(f"unknown .cistem column id {cid}")
        name, exp_tc = COLUMNS[cid]
        cids.append(cid)
        fields.append((name, _TYPE_NP[tc if tc in _TYPE_NP else exp_tc]))
    dtype = np.dtype(fields)
    rec = np.frombuffer(f.read(nrow * dtype.itemsize), dtype=dtype, count=nrow)
    t = Table(column_ids=cids)
    for name, _ in fields:
        t.data[name] = np.ascontiguousarray(rec[name])
    return t


def write_parameters(table: Table, path):
    """Write the main per-projection parameter file."""
    with open(path, "wb") as f:
        _write_block(f, table)


def read_parameters(path) -> Table:
    with open(path, "rb") as f:
        return _read_block(f)


def write_extended(particles: Table, tilts: Table, path):
    """Write the PYP extended file: PIND block then TIND block."""
    with open(path, "wb") as f:
        for block_id, tbl in ((PIND, particles), (TIND, tilts)):
            f.write(struct.pack("<q", block_id))
            _write_block(f, tbl)


def read_extended(path):
    blocks = {}
    with open(path, "rb") as f:
        for _ in range(2):
            raw = f.read(8)
            if len(raw) < 8:
                break
            (block_id,) = struct.unpack("<q", raw)
            blocks[block_id] = _read_block(f)
    return blocks.get(PIND), blocks.get(TIND)


def merge_tables(tables) -> Table:
    """Row-concatenate tables with identical schemas (merge of split outputs)."""
    tables = list(tables)
    out = Table(column_ids=list(tables[0].column_ids))
    for cid in out.column_ids:
        name = COLUMNS[cid][0]
        out.data[name] = np.concatenate([t.data[name] for t in tables])
    return out
