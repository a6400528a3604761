"""Digital Micrograph DM3/DM4 reader (Gatan).

Functional equivalent of the reference's 1,316-line parser (inout/image/
digital_micrograph.py) built from the public DM tag-tree format description:
a header, then a nested tag directory; images live in ImageList.ImageData
(Data array + Dimensions). Reads the largest image array (the recorded
image; thumbnails are smaller). DM3 = 32-bit sizes, DM4 = 64-bit.

The port's own copy of pyp_tpu/io/dm.py.
"""

from __future__ import annotations

import struct

import numpy as np

# DM element type codes -> numpy dtypes
_DTYPES = {
    2: np.int16, 3: np.int32, 4: np.uint16, 5: np.uint32,
    6: np.float32, 7: np.float64, 8: np.uint8, 9: np.int8,
    10: np.int8, 11: np.int64, 12: np.uint64,
}


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.version = 3
        self.arrays: list[tuple[tuple, np.ndarray]] = []
        self.cur_dims: list[int] = []

    def u8(self):
        v = self.data[self.pos]
        self.pos += 1
        return v

    def be(self, fmt, size):
        v = struct.unpack_from(">" + fmt, self.data, self.pos)[0]
        self.pos += size
        return v

    def size_field(self):
        return self.be("Q", 8) if self.version == 4 else self.be("I", 4)

    def parse(self):
        self.version = self.be("I", 4)
        if self.version not in (3, 4):
            raise ValueError(f"not a DM3/DM4 file (version {self.version})")
        _rootlen = self.size_field()
        self.little_endian = self.be("I", 4) == 1
        self._tag_group(depth=0, path=())
        return self

    def _tag_group(self, depth, path):
        _sorted = self.u8()
        _open = self.u8()
        n_tags = self.size_field()
        for _ in range(n_tags):
            self._tag_entry(depth, path)

    def _tag_entry(self, depth, path):
        kind = self.u8()
        name_len = self.be("H", 2)
        name = self.data[self.pos:self.pos + name_len].decode("latin1")
        self.pos += name_len
        if self.version == 4:
            _block_size = self.be("Q", 8)
        if kind == 20:  # nested group
            self._tag_group(depth + 1, path + (name,))
        elif kind == 21:  # data tag
            self._tag_data(path + (name,))
        else:
            raise ValueError(f"bad tag kind {kind} at {self.pos}")

    def _tag_data(self, path):
        magic = self.data[self.pos:self.pos + 4]
        self.pos += 4
        if magic != b"%%%%":
            raise ValueError("missing %%%% delimiter")
        n_info = self.size_field()
        info = [self.size_field() for _ in range(n_info)]
        self._read_value(info, path)

    def _read_value(self, info, path):
        t = info[0]
        endian = "<" if self.little_endian else ">"
        if t in _DTYPES and len(info) == 1:
            dt = np.dtype(_DTYPES[t]).newbyteorder(endian)
            val = np.frombuffer(self.data, dt, 1, self.pos)[0]
            self.pos += dt.itemsize
            self._record_scalar(path, val)
        elif t == 18:  # string
            length = info[1]
            self.pos += length
        elif t == 15:  # struct
            n_fields = info[2]
            field_types = [info[4 + 2 * i] for i in range(n_fields)]
            for ft in field_types:
                dt = np.dtype(_DTYPES.get(ft, np.uint8))
                self.pos += dt.itemsize
        elif t == 20:  # array
            elem = info[1]
            if elem == 15:  # array of structs
                n_fields = info[3]
                field_types = [info[5 + 2 * i] for i in range(n_fields)]
                elem_size = sum(np.dtype(_DTYPES.get(ft, np.uint8)).itemsize
                                for ft in field_types)
                count = info[-1]
                self.pos += elem_size * count
            else:
                dt = np.dtype(_DTYPES.get(elem, np.uint8)).newbyteorder(endian)
                count = info[-1]
                arr = np.frombuffer(self.data, dt, count, self.pos)
                self.pos += dt.itemsize * count
                if path[-1] == "Data":
                    self.arrays.append((path, arr))
        else:
            raise ValueError(f"unsupported DM tag type {t}")

    def _record_scalar(self, path, val):
        if path[-1] in ("ImageWidth",):
            pass
        # dimensions live as .../Dimensions/<index> scalars
        if len(path) >= 2 and path[-2] == "Dimensions":
            self.cur_dims.append(int(val))


def read(path):
    """Read the main image of a DM3/DM4 file -> numpy array (ny, nx) or
    (nz, ny, nx)."""
    with open(path, "rb") as f:
        raw = f.read()
    r = _Reader(raw).parse()
    if not r.arrays:
        raise ValueError("no image data found")
    # largest Data array is the recorded image
    path_arr, arr = max(r.arrays, key=lambda pa: pa[1].size)
    dims = r.cur_dims
    # use the trailing dims whose product matches the array size
    for k in range(len(dims), 0, -1):
        for combo_start in range(len(dims) - k + 1):
            cand = dims[combo_start:combo_start + k]
            if int(np.prod(cand)) == arr.size:
                return arr.reshape(tuple(reversed(cand)))
    side = int(round(arr.size ** 0.5))
    if side * side == arr.size:
        return arr.reshape(side, side)
    return arr


def write_dm4(data, path):
    """Minimal DM4 writer (single image, for round-trip tests): version
    header + one tag group containing Dimensions scalars and the Data
    array — enough structure for `read` and for third-party parsers that
    walk the tag tree leniently."""
    data = np.asarray(data)
    dims = list(reversed(data.shape))
    dt_code = {np.dtype(np.int16): 2, np.dtype(np.int32): 3,
               np.dtype(np.uint16): 4, np.dtype(np.uint32): 5,
               np.dtype(np.float32): 6, np.dtype(np.float64): 7,
               np.dtype(np.uint8): 8, np.dtype(np.int8): 9}.get(data.dtype)
    if dt_code is None:
        data = data.astype(np.float32)
        dt_code = 6

    out = bytearray()

    def tag_data_scalar(name: str, code: int, value: int):
        body = b"%%%%" + struct.pack(">Q", 1) + struct.pack(">Q", code)
        dt = np.dtype(_DTYPES[code]).newbyteorder("<")
        body += np.array([value], dt).tobytes()
        entry = bytes([21]) + struct.pack(">H", len(name)) + name.encode()
        entry += struct.pack(">Q", len(body)) + body
        return entry

    def tag_data_array(name: str, arr: np.ndarray):
        body = b"%%%%" + struct.pack(">Q", 3)
        body += struct.pack(">Q", 20) + struct.pack(">Q", dt_code)
        body += struct.pack(">Q", arr.size)
        body += arr.astype(arr.dtype.newbyteorder("<")).tobytes()
        entry = bytes([21]) + struct.pack(">H", len(name)) + name.encode()
        entry += struct.pack(">Q", len(body)) + body
        return entry

    def group(entries: list[bytes]):
        return bytes([1, 0]) + struct.pack(">Q", len(entries)) + b"".join(entries)

    def named_group(name: str, body: bytes):
        entry = bytes([20]) + struct.pack(">H", len(name)) + name.encode()
        entry += struct.pack(">Q", len(body)) + body
        return entry

    dim_entries = [tag_data_scalar(str(i), 3, d) for i, d in enumerate(dims)]
    img_data = group([
        named_group("Dimensions", group(dim_entries)),
        tag_data_array("Data", data.reshape(-1)),
    ])
    root = group([named_group("ImageList", group([named_group("0", group([
        named_group("ImageData", img_data)
    ]))]))])

    out += struct.pack(">I", 4)           # version
    out += struct.pack(">Q", len(root))   # root length
    out += struct.pack(">I", 1)           # little-endian data
    out += root
    with open(path, "wb") as f:
        f.write(bytes(out))
