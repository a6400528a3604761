"""Minimal TIFF reader for counting-camera movies (K2/K3 style).

The reference converts TIFF/EER movies to MRC via IMOD (inout/image/
core.py:913 readMoviefileandsave); here we read TIFF natively: classic TIFF
(little/big endian), multi-page (one frame per IFD), grayscale 8/16-bit,
strip-based, uncompressed (1), LZW (5), or Deflate (8/32946) compression,
with horizontal-differencing predictor. Enough for cryo-EM movie data; no
tiles, no color. The port's own copy of pyp_tpu/io/tiff.py. LZW strips go
to the native pypio library (`io.native`) as in the JAX package, and to
the Python decoder where it is absent; `LZW_ROUTES` counts the strips
each route decoded.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

TAG_WIDTH = 256
TAG_HEIGHT = 257
TAG_BITS = 258
TAG_COMPRESSION = 259
TAG_STRIP_OFFSETS = 273
TAG_ROWS_PER_STRIP = 278
TAG_STRIP_COUNTS = 279
TAG_PREDICTOR = 317
TAG_SAMPLE_FORMAT = 339

# LZW strips decoded by each route since import
LZW_ROUTES = {"native": 0, "python": 0}

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
               11: 4, 12: 8, 16: 8, 17: 8, 18: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f",
             12: "d", 16: "Q", 17: "q"}


def _lzw_decode(data: bytes) -> bytes:
    """TIFF-variant LZW (MSB-first codes, EarlyChange)."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    table: list[bytes] = []

    def reset():
        nonlocal table
        table = [bytes([i]) for i in range(256)] + [b"", b""]

    reset()
    bitbuf = 0
    bitcnt = 0
    code_size = 9
    prev: bytes | None = None
    pos = 0
    n = len(data)
    while True:
        while bitcnt < code_size and pos < n:
            bitbuf = (bitbuf << 8) | data[pos]
            pos += 1
            bitcnt += 8
        if bitcnt < code_size:
            break
        code = (bitbuf >> (bitcnt - code_size)) & ((1 << code_size) - 1)
        bitcnt -= code_size
        if code == CLEAR:
            reset()
            code_size = 9
            prev = None
            continue
        if code == EOI:
            break
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        else:
            entry = prev + prev[:1]
            table.append(entry)
        out += entry
        prev = entry
        # EarlyChange: bump code size one code early
        if len(table) + 1 >= (1 << code_size) and code_size < 12:
            code_size += 1
    return bytes(out)


def _read_ifd(f, offset, endian):
    f.seek(offset)
    (n_entries,) = struct.unpack(endian + "H", f.read(2))
    tags = {}
    for _ in range(n_entries):
        tag, typ, count = struct.unpack(endian + "HHI", f.read(8))
        raw = f.read(4)
        size = _TYPE_SIZES.get(typ, 1) * count
        if size <= 4:
            data = raw[:size]
        else:
            (ptr,) = struct.unpack(endian + "I", raw)
            cur = f.tell()
            f.seek(ptr)
            data = f.read(size)
            f.seek(cur)
        if typ in _TYPE_FMT:
            vals = struct.unpack(endian + _TYPE_FMT[typ] * count, data)
            tags[tag] = vals if count > 1 else (vals[0],)
    (next_ifd,) = struct.unpack(endian + "I", f.read(4))
    return tags, next_ifd


def read(path, frames=None) -> np.ndarray:
    """Read a grayscale (multi-page) TIFF into (n_frames, ny, nx)."""
    with open(path, "rb") as f:
        header = f.read(8)
        if header[:2] == b"II":
            endian = "<"
        elif header[:2] == b"MM":
            endian = ">"
        else:
            raise ValueError("not a TIFF file")
        (magic,) = struct.unpack(endian + "H", header[2:4])
        if magic != 42:
            raise ValueError(f"unsupported TIFF magic {magic} (bigtiff not supported)")
        (ifd_offset,) = struct.unpack(endian + "I", header[4:8])

        pages = []
        while ifd_offset:
            tags, ifd_offset = _read_ifd(f, ifd_offset, endian)
            pages.append(tags)

        if frames is not None:
            pages = [pages[i] for i in frames]

        out = []
        for tags in pages:
            width = tags[TAG_WIDTH][0]
            height = tags[TAG_HEIGHT][0]
            bits = tags.get(TAG_BITS, (8,))[0]
            comp = tags.get(TAG_COMPRESSION, (1,))[0]
            predictor = tags.get(TAG_PREDICTOR, (1,))[0]
            fmt = tags.get(TAG_SAMPLE_FORMAT, (1,))[0]
            offsets = tags[TAG_STRIP_OFFSETS]
            counts = tags[TAG_STRIP_COUNTS]
            rows_per_strip = tags.get(TAG_ROWS_PER_STRIP, (height,))[0]

            if bits == 4:
                # K3 counting movies (SerialEM writes 4-bit TIFF; the
                # reference converts them through IMOD, inout/image/
                # core.py:913). TIFF packs two pixels per byte, rows padded
                # to whole bytes, HIGH nibble first (spec FillOrder=1).
                dtype = np.dtype("u1")
            elif bits == 8:
                dtype = np.dtype(endian + ("i1" if fmt == 2 else "u1"))
            elif bits == 16:
                dtype = np.dtype(endian + ("i2" if fmt == 2 else "u2"))
            elif bits == 32:
                dtype = np.dtype(endian + ("f4" if fmt == 3 else "i4" if fmt == 2 else "u4"))
            else:
                raise ValueError(f"unsupported bit depth {bits}")

            rows = []
            for off, cnt in zip(offsets, counts):
                f.seek(off)
                raw = f.read(cnt)
                if comp == 1:
                    pass
                elif comp == 5:
                    from pyp_tpu_torch.io import native

                    row_bytes = ((width * bits + 7) // 8)
                    expected = rows_per_strip * row_bytes
                    decoded = native.lzw_decode(raw, expected)
                    route = "python" if decoded is None else "native"
                    LZW_ROUTES[route] += 1
                    raw = decoded if decoded is not None else _lzw_decode(raw)
                elif comp in (8, 32946):
                    raw = zlib.decompress(raw)
                else:
                    raise ValueError(f"unsupported TIFF compression {comp}")
                if bits == 4:
                    rb = (width + 1) // 2
                    packed = np.frombuffer(raw, dtype=np.uint8)
                    nrows = len(packed) // rb
                    packed = packed[: nrows * rb].reshape(nrows, rb)
                    strip = np.empty((nrows, rb * 2), dtype=np.uint8)
                    strip[:, 0::2] = packed >> 4       # high nibble first
                    strip[:, 1::2] = packed & 0x0F
                    strip = strip[:, :width]
                else:
                    strip = np.frombuffer(raw, dtype=dtype)
                    nrows = len(strip) // width
                    strip = strip[: nrows * width].reshape(nrows, width)
                rows.append(strip)
            img = np.concatenate(rows, axis=0)[:height]
            if predictor == 2:
                img = np.cumsum(img.astype(np.int64), axis=1).astype(dtype)
            out.append(img)
        return np.stack(out)


def write(data, path, bits=None):
    """Write (n, ny, nx) or (ny, nx) as an uncompressed multi-page TIFF
    (little endian) — for interop tests and simple exports.

    bits=4 packs uint8 values < 16 two-per-byte, high nibble first (the
    SerialEM K3 counting-movie layout)."""
    data = np.asarray(data)
    if data.ndim == 2:
        data = data[None]
    pack4 = bits == 4
    if pack4:
        data = data.astype(np.uint8)
        if data.max() > 15:
            raise ValueError("4-bit TIFF requires values < 16")
    elif data.dtype not in (np.uint8, np.uint16, np.int16, np.float32):
        data = data.astype(np.float32)
    n, h, w = data.shape
    bits = 4 if pack4 else data.dtype.itemsize * 8
    fmt = 3 if data.dtype.kind == "f" else (2 if data.dtype.kind == "i" else 1)

    def page_bytes(img):
        if not pack4:
            return np.ascontiguousarray(img).astype(
                img.dtype.newbyteorder("<")).tobytes()
        if w % 2:
            img = np.concatenate([img, np.zeros((h, 1), np.uint8)], axis=1)
        return ((img[:, 0::2] << 4) | img[:, 1::2]).tobytes()

    with open(path, "wb") as f:
        f.write(b"II*\x00")
        ifd_pos_holder = f.tell()
        f.write(struct.pack("<I", 0))  # patched below

        prev_next_ptr = ifd_pos_holder
        for i in range(n):
            strip = page_bytes(data[i])
            strip_off = f.tell()
            f.write(strip)
            ifd_off = f.tell()
            # patch previous IFD pointer
            cur = f.tell()
            f.seek(prev_next_ptr)
            f.write(struct.pack("<I", ifd_off))
            f.seek(cur)
            entries = [
                (TAG_WIDTH, 4, 1, w),
                (TAG_HEIGHT, 4, 1, h),
                (TAG_BITS, 3, 1, bits),
                (TAG_COMPRESSION, 3, 1, 1),
                (262, 3, 1, 1),  # photometric: BlackIsZero
                (TAG_STRIP_OFFSETS, 4, 1, strip_off),
                (TAG_ROWS_PER_STRIP, 4, 1, h),
                (TAG_STRIP_COUNTS, 4, 1, len(strip)),
                (TAG_SAMPLE_FORMAT, 3, 1, fmt),
            ]
            f.write(struct.pack("<H", len(entries)))
            for tag, typ, count, value in entries:
                f.write(struct.pack("<HHI", tag, typ, count))
                f.write(struct.pack("<I", value))
            prev_next_ptr = f.tell()
            f.write(struct.pack("<I", 0))
