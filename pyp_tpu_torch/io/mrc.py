"""MRC2014 image file codec (read / write / mmap / stack append & merge).

Functional equivalent of the reference's pure-python MRC layer
(the reference's src/pyp/inout/image/mrc.py: parseHeader :312, write :537,
merge_fast :643, append :763, mmap :923) re-implemented from the public
MRC2014 specification. Supports modes 0 (int8), 1 (int16), 2 (float32),
6 (uint16), 12 (float16), plus complex modes 3/4 for Fourier dumps.

The port's own copy of pyp_tpu/io/mrc.py; keep the two in step.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field

import numpy as np

HEADER_SIZE = 1024

# MRC mode -> numpy dtype (little endian assumed; we check machine stamp)
MODE_DTYPES = {
    0: np.dtype("i1"),
    1: np.dtype("<i2"),
    2: np.dtype("<f4"),
    3: np.dtype([("re", "<i2"), ("im", "<i2")]),
    4: np.dtype("<c8"),
    6: np.dtype("<u2"),
    12: np.dtype("<f2"),
    101: np.dtype("u1"),  # 4-bit packed is 101; we expose as uint8 pairs
}

DTYPE_MODES = {
    np.dtype("i1"): 0,
    np.dtype("i2"): 1,
    np.dtype("f4"): 2,
    np.dtype("c8"): 4,
    np.dtype("u2"): 6,
    np.dtype("f2"): 12,
}


@dataclass
class MrcHeader:
    nx: int = 0
    ny: int = 0
    nz: int = 0
    mode: int = 2
    nxstart: int = 0
    nystart: int = 0
    nzstart: int = 0
    mx: int = 1
    my: int = 1
    mz: int = 1
    xlen: float = 1.0
    ylen: float = 1.0
    zlen: float = 1.0
    alpha: float = 90.0
    beta: float = 90.0
    gamma: float = 90.0
    mapc: int = 1
    mapr: int = 2
    maps: int = 3
    amin: float = 0.0
    amax: float = 0.0
    amean: float = 0.0
    ispg: int = 0
    nsymbt: int = 0
    extra: bytes = b"\0" * 100
    origin: tuple = (0.0, 0.0, 0.0)
    map_id: bytes = b"MAP "
    machst: bytes = b"\x44\x44\x00\x00"
    rms: float = -1.0
    nlabl: int = 0
    labels: list = field(default_factory=list)
    byte_order: str = "<"   # ">" for big-endian files (header + data)

    @property
    def pixel_size(self) -> float:
        return float(self.xlen) / max(self.mx, 1)

    @property
    def dtype(self) -> np.dtype:
        dt = MODE_DTYPES[self.mode]
        if self.byte_order == ">" and dt.itemsize > 1:
            dt = dt.newbyteorder(">")
        return dt

    @property
    def shape(self):
        return (self.nz, self.ny, self.nx)

    def pack(self) -> bytes:
        buf = bytearray(HEADER_SIZE)
        struct.pack_into(
            "<10i6f3i3f3i",
            buf,
            0,
            self.nx, self.ny, self.nz, self.mode,
            self.nxstart, self.nystart, self.nzstart,
            self.mx, self.my, self.mz,
            self.xlen, self.ylen, self.zlen,
            self.alpha, self.beta, self.gamma,
            self.mapc, self.mapr, self.maps,
            self.amin, self.amax, self.amean,
            self.ispg, self.nsymbt, 0,
        )
        buf[96 : 96 + 100] = self.extra[:100].ljust(100, b"\0")
        struct.pack_into("<3f", buf, 196, *self.origin)
        buf[208:212] = self.map_id
        buf[212:216] = self.machst
        struct.pack_into("<f", buf, 216, self.rms)
        struct.pack_into("<i", buf, 220, self.nlabl)
        for i, label in enumerate(self.labels[:10]):
            raw = label.encode() if isinstance(label, str) else label
            buf[224 + 80 * i : 224 + 80 * (i + 1)] = raw[:80].ljust(80, b" ")
        return bytes(buf)

    @classmethod
    def unpack(cls, raw: bytes) -> "MrcHeader":
        # endianness from the machine stamp (MRC2014: 0x44 0x44/0x41 =
        # little, 0x11 0x11 = big — the reference relies on IMOD for
        # big-endian files; legacy files may have a zeroed stamp, so also
        # sanity-check the mode field)
        machst = raw[212:216]
        big = machst[:2] == b"\x11\x11"
        if not big and machst[0] not in (0x44,):
            mode_le = struct.unpack_from("<i", raw, 12)[0]
            mode_be = struct.unpack_from(">i", raw, 12)[0]
            if mode_le not in MODE_DTYPES and mode_be in MODE_DTYPES:
                big = True
        if big:
            hdr = cls._unpack_order(raw, ">")
            hdr.byte_order = ">"
            return hdr
        return cls._unpack_order(raw, "<")

    @classmethod
    def _unpack_order(cls, raw: bytes, bo: str) -> "MrcHeader":
        vals = struct.unpack_from(bo + "10i6f3i3f3i", raw, 0)
        hdr = cls(
            nx=vals[0], ny=vals[1], nz=vals[2], mode=vals[3],
            nxstart=vals[4], nystart=vals[5], nzstart=vals[6],
            mx=vals[7], my=vals[8], mz=vals[9],
            xlen=vals[10], ylen=vals[11], zlen=vals[12],
            alpha=vals[13], beta=vals[14], gamma=vals[15],
            mapc=vals[16], mapr=vals[17], maps=vals[18],
            amin=vals[19], amax=vals[20], amean=vals[21],
            ispg=vals[22], nsymbt=vals[23],
        )
        hdr.extra = raw[96:196]
        hdr.origin = struct.unpack_from(bo + "3f", raw, 196)
        hdr.map_id = raw[208:212]
        hdr.machst = raw[212:216]
        hdr.rms = struct.unpack_from(bo + "f", raw, 216)[0]
        hdr.nlabl = struct.unpack_from(bo + "i", raw, 220)[0]
        hdr.labels = [
            raw[224 + 80 * i : 224 + 80 * (i + 1)].rstrip(b"\0 ").decode("ascii", "replace")
            for i in range(min(max(hdr.nlabl, 0), 10))
        ]
        return hdr


def read_header(path) -> MrcHeader:
    with open(path, "rb") as f:
        return MrcHeader.unpack(f.read(HEADER_SIZE))


def read(path, slices=None) -> np.ndarray:
    """Read an MRC file into a numpy array of shape (nz, ny, nx) (2D -> (ny, nx)).

    `slices` may be an int, a slice, or a sequence of z indices to read a
    subset of sections without loading the full stack.
    """
    hdr = read_header(path)
    dtype = hdr.dtype
    frame_items = hdr.ny * hdr.nx
    frame_bytes = frame_items * dtype.itemsize
    if hdr.mode == 101:
        # 4-bit packed (K2/K3 counting movies; the reference unpacks these
        # through IMOD, inout/image/core.py:913): two pixels per byte along
        # x, low nibble first, rows padded to a whole byte
        frame_bytes = ((hdr.nx + 1) // 2) * hdr.ny
    offset0 = HEADER_SIZE + hdr.nsymbt
    with open(path, "rb") as f:
        def read_frames(zs):
            out = np.empty((len(zs), hdr.ny, hdr.nx), dtype=dtype)
            for k, z in enumerate(zs):
                f.seek(offset0 + z * frame_bytes)
                raw = np.frombuffer(f.read(frame_bytes), dtype=np.uint8)
                if hdr.mode == 101:
                    out[k] = _unpack_4bit(raw, hdr.ny, hdr.nx)
                else:
                    out[k] = raw.view(dtype).reshape(hdr.ny, hdr.nx)
            return out

        if slices is None:
            data = read_frames(list(range(hdr.nz)))
            if hdr.nz == 1:
                data = data[0]
            return np.ascontiguousarray(data)
        if isinstance(slices, int):
            idx = [slices]
        elif isinstance(slices, slice):
            idx = list(range(*slices.indices(hdr.nz)))
        else:
            idx = list(slices)
        out = read_frames(idx)
        if isinstance(slices, int):
            return out[0]
        return out


def _unpack_4bit(raw: np.ndarray, ny: int, nx: int) -> np.ndarray:
    """Row-padded 4-bit packed bytes -> (ny, nx) uint8 (low nibble first)."""
    rb = (nx + 1) // 2
    rows = raw[: rb * ny].reshape(ny, rb)
    out = np.empty((ny, rb * 2), dtype=np.uint8)
    out[:, 0::2] = rows & 0x0F
    out[:, 1::2] = rows >> 4
    return out[:, :nx]


def pack_4bit(data: np.ndarray) -> np.ndarray:
    """(ny, nx) uint8 values <16 -> row-padded packed bytes (inverse of
    _unpack_4bit; fixture/interop utility)."""
    data = np.asarray(data, dtype=np.uint8)
    ny, nx = data.shape
    if nx % 2:
        data = np.concatenate([data, np.zeros((ny, 1), np.uint8)], axis=1)
    return (data[:, 0::2] | (data[:, 1::2] << 4)).reshape(-1)


def write_packed4(data, path, pixel_size: float = 1.0):
    """Write (nz, ny, nx) small-count frames as MRC mode 101 (test/interop
    utility — real mode-101 files come from SerialEM/K3 counting)."""
    data = np.asarray(data, dtype=np.uint8)
    if data.ndim == 2:
        data = data[None]
    nz, ny, nx = data.shape
    hdr = MrcHeader(
        nx=nx, ny=ny, nz=nz, mode=101, mx=nx, my=ny, mz=nz,
        xlen=nx * pixel_size, ylen=ny * pixel_size, zlen=nz * pixel_size,
        amin=float(data.min()), amax=float(data.max()),
        amean=float(data.mean()),
    )
    with open(path, "wb") as f:
        f.write(hdr.pack())
        for z in range(nz):
            f.write(pack_4bit(data[z]).tobytes())


def mmap(path) -> np.ndarray:
    """Memory-map the data section of an MRC file (read-only)."""
    hdr = read_header(path)
    if hdr.mode == 101:
        raise ValueError("mode 101 (4-bit packed) cannot be mmapped; "
                         "use mrc.read()")
    return np.memmap(
        path, dtype=hdr.dtype, mode="r",
        offset=HEADER_SIZE + hdr.nsymbt, shape=(hdr.nz, hdr.ny, hdr.nx),
    )


def _normalize(data: np.ndarray):
    data = np.asarray(data)
    if data.ndim == 2:
        data = data[None]
    if data.ndim != 3:
        raise ValueError(f"MRC data must be 2D or 3D, got shape {data.shape}")
    if data.dtype == np.float64:
        data = data.astype(np.float32)
    if data.dtype == np.complex128:
        data = data.astype(np.complex64)
    if data.dtype == np.int64 or data.dtype == np.int32:
        data = data.astype(np.float32)
    if data.dtype == np.bool_:
        data = data.astype(np.int8)
    if data.dtype.kind == "f" and data.dtype.itemsize == 2:
        pass
    return data


def write(data, path, pixel_size: float = 1.0, origin=(0.0, 0.0, 0.0), stats=True):
    """Write a 2D/3D array as an MRC2014 file."""
    data = _normalize(data)
    mode = DTYPE_MODES[data.dtype.newbyteorder("=")]
    nz, ny, nx = data.shape
    hdr = MrcHeader(
        nx=nx, ny=ny, nz=nz, mode=mode,
        mx=nx, my=ny, mz=nz,
        xlen=pixel_size * nx, ylen=pixel_size * ny, zlen=pixel_size * nz,
        origin=tuple(origin),
        ispg=1 if nz == nx and nz > 1 else 0,
        nlabl=1, labels=["pyp_tpu"],
    )
    if stats and data.dtype.kind == "f":
        hdr.amin = float(np.min(data))
        hdr.amax = float(np.max(data))
        hdr.amean = float(np.mean(data))
        hdr.rms = float(np.std(data))
    with open(path, "wb") as f:
        f.write(hdr.pack())
        f.write(np.ascontiguousarray(data).astype(data.dtype.newbyteorder("<")).tobytes())


def append(data, path, pixel_size: float = 1.0):
    """Append sections to an existing MRC stack (creates the file if absent)."""
    data = _normalize(data)
    if not os.path.exists(path):
        write(data, path, pixel_size=pixel_size)
        return
    hdr = read_header(path)
    if (hdr.ny, hdr.nx) != data.shape[1:]:
        raise ValueError(f"append shape mismatch: file {hdr.shape} vs data {data.shape}")
    if hdr.dtype != data.dtype.newbyteorder("<"):
        data = data.astype(hdr.dtype)
    with open(path, "r+b") as f:
        f.seek(0, os.SEEK_END)
        f.write(np.ascontiguousarray(data).tobytes())
        hdr.nz += data.shape[0]
        hdr.mz = hdr.nz
        hdr.zlen = hdr.pixel_size * hdr.nz
        f.seek(0)
        f.write(hdr.pack())


def merge(paths, out_path, pixel_size: float | None = None):
    """Concatenate MRC stacks along z into `out_path` by raw block copy.

    Equivalent of the reference's merge_fast (mrc.py:643): header from the
    first file, data sections streamed without decode.
    """
    first = read_header(paths[0])
    if pixel_size is None:
        pixel_size = first.pixel_size
    total_nz = 0
    with open(out_path, "wb") as out:
        out.write(first.pack())  # placeholder, fixed below
        for p in paths:
            hdr = read_header(p)
            if (hdr.ny, hdr.nx, hdr.mode) != (first.ny, first.nx, first.mode):
                raise ValueError(f"stack mismatch merging {p}")
            with open(p, "rb") as f:
                f.seek(HEADER_SIZE + hdr.nsymbt)
                while True:
                    chunk = f.read(1 << 24)
                    if not chunk:
                        break
                    out.write(chunk)
            total_nz += hdr.nz
        first.nz = total_nz
        first.mz = total_nz
        first.nsymbt = 0
        first.zlen = pixel_size * total_nz
        out.seek(0)
        out.write(first.pack())
