"""EER (Electron Event Representation) movie decoding.

The reference converts EER via IMOD/relion tools (inout/image/core.py:913).
Here the TIFF container is parsed with pyp_tpu_torch.io.tiff machinery and the
event bitstream is decoded natively.

Bitstream model (from the published EER description; Thermo Fisher Falcon):
each frame is a little-endian bitstream of events on the 4096x4096 sensor in
raster order. Per event, compression id 65001 ("EER 7/4"):

    7 bits  run-length of empty pixels before this event (127 = no event,
            skip 127 pixels and continue)
    4 bits  sub-pixel position (2 bits x, 2 bits y) for 2x upsampled
            rendering (16k mode uses them fully; 4k rendering ignores them)

compression id 65000 uses 8-bit run-lengths (255 = skip-only) and no
sub-pixel bits.

Sub-pixel convention: the 4 bits are (sub_y << 2) | sub_x, and each 2-bit
value is stored XOR 2 (raw 0 = third quarter-pixel), so rendering at 8k/16k
recenters with `^ 2` — getting this wrong shifts every electron by half a
pixel at super-resolution.

Validation: byte-level spec vectors hand-packed bit-by-bit (independent of
this module's encoder) in tests/test_formats.py, plus encode/decode
round-trips and count statistics. Camera-produced fragments still welcome
(no EER file ships in the reference repo either).

The port's own copy of pyp_tpu/io/eer.py.
"""

from __future__ import annotations

import numpy as np

from pyp_tpu_torch.io import tiff as tiff_mod

EER_SENSOR = 4096
COMPRESSION_EER8 = 65000
COMPRESSION_EER7 = 65001


class _BitReader:
    def __init__(self, data: bytes):
        self.data = np.frombuffer(data, dtype=np.uint8)
        self.pos = 0  # bit position

    def read(self, nbits: int) -> int:
        """Little-endian bit order (LSB of each byte first)."""
        out = 0
        for i in range(nbits):
            byte = self.pos >> 3
            if byte >= len(self.data):
                return -1
            bit = (self.data[byte] >> (self.pos & 7)) & 1
            out |= int(bit) << i
            self.pos += 1
        return out


class _BitWriter:
    def __init__(self):
        self.bits = []

    def write(self, value: int, nbits: int):
        for i in range(nbits):
            self.bits.append((value >> i) & 1)

    def tobytes(self) -> bytes:
        n = (len(self.bits) + 7) // 8
        out = bytearray(n)
        for i, b in enumerate(self.bits):
            if b:
                out[i >> 3] |= 1 << (i & 7)
        return bytes(out)


def decode_frame(data: bytes, compression: int = COMPRESSION_EER7,
                 size: int = EER_SENSOR, upsampling: int = 1) -> np.ndarray:
    """Decode one EER frame bitstream into an electron-count image
    (size*upsampling)². upsampling 1 (4k) ignores sub-pixel bits; 2 (8k)
    uses their high bit; 4 (16k) uses both bits."""
    rle_bits = 7 if compression == COMPRESSION_EER7 else 8
    sub_bits = 4 if compression == COMPRESSION_EER7 else 0
    max_run = (1 << rle_bits) - 1
    n_out = size * upsampling
    img = np.zeros(n_out * n_out, dtype=np.uint16)
    reader = _BitReader(data)
    pos = 0
    total = size * size
    while pos < total:
        run = reader.read(rle_bits)
        if run < 0:
            break
        pos += run
        if run == max_run:
            continue  # skip-only marker: no event follows
        if pos >= total:
            break
        sub = reader.read(sub_bits) if sub_bits else 0
        if sub < 0:
            break
        y, x = divmod(pos, size)
        if upsampling > 1 and sub_bits:
            # low 2 bits = sub-x, high 2 bits = sub-y, each XOR 2: raw 0
            # addresses the 3rd quarter-pixel, so the stored values are
            # offset by half a pixel and ^2 recenters them (the published
            # EER convention; a straight shift places every electron in
            # the wrong half-pixel at 8k/16k rendering)
            sx = (sub & 0x3) ^ 2
            sy = ((sub >> 2) & 0x3) ^ 2
            if upsampling == 4:         # 16k rendering
                ux = x * 4 + sx
                uy = y * 4 + sy
            else:                       # 8k rendering
                ux = x * 2 + (sx >> 1)
                uy = y * 2 + (sy >> 1)
            img[uy * n_out + ux] += 1
        else:
            img[y * n_out + x] += 1
        pos += 1
    return img.reshape(n_out, n_out)


def encode_frame(counts: np.ndarray, compression: int = COMPRESSION_EER7,
                 rng=None) -> bytes:
    """Encode a binary event image into an EER bitstream (test/interop
    utility). Counting frames are sparse 0/1 — counts are clipped to 1
    (one event per pixel per frame, as the physical format)."""
    rle_bits = 7 if compression == COMPRESSION_EER7 else 8
    sub_bits = 4 if compression == COMPRESSION_EER7 else 0
    max_run = (1 << rle_bits) - 1
    flat = (counts.reshape(-1) > 0)
    writer = _BitWriter()
    if rng is None:
        rng = np.random.RandomState(0)
    last = -1
    for pos in np.nonzero(flat)[0]:
        gap = int(pos - last - 1)
        while gap >= max_run:
            writer.write(max_run, rle_bits)
            gap -= max_run
        writer.write(gap, rle_bits)
        if sub_bits:
            writer.write(int(rng.randint(0, 16)), sub_bits)
        last = int(pos)
    writer.write(max_run, rle_bits)
    return writer.tobytes()


def write(path, stack, compression: int = COMPRESSION_EER7):
    """Write (F, n, n) electron-count frames as a minimal EER file (TIFF
    container, one IFD per frame, single strip) readable by `read` — the
    interop/test counterpart of the camera files (inout/image/core.py:913)."""
    import io as _io
    import struct
    from pathlib import Path

    stack = np.asarray(stack)
    F, n, nx = stack.shape
    if n != nx:
        raise ValueError("EER frames are square")
    blobs = [encode_frame(f, compression) for f in stack]

    out = _io.BytesIO()
    out.write(b"II*\x00")
    out.write(struct.pack("<I", 0))  # first-IFD offset, patched below
    offsets = []
    for b in blobs:
        offsets.append(out.tell())
        out.write(b)
        if out.tell() % 2:
            out.write(b"\x00")
    prev_ptr_pos = 4
    for i, b in enumerate(blobs):
        ifd_off = out.tell()
        entries = (
            (tiff_mod.TAG_WIDTH, 3, n),
            (tiff_mod.TAG_HEIGHT, 3, n),
            (tiff_mod.TAG_COMPRESSION, 3, compression),
            (tiff_mod.TAG_STRIP_OFFSETS, 4, offsets[i]),
            (tiff_mod.TAG_STRIP_COUNTS, 4, len(b)),
        )
        out.write(struct.pack("<H", len(entries)))
        for tag, typ, val in entries:
            out.write(struct.pack("<HHI", tag, typ, 1))
            if typ == 3:
                out.write(struct.pack("<H", val) + b"\x00\x00")
            else:
                out.write(struct.pack("<I", val))
        next_ptr_pos = out.tell()
        out.write(struct.pack("<I", 0))
        buf = out.getbuffer()
        struct.pack_into("<I", buf, prev_ptr_pos, ifd_off)
        del buf
        prev_ptr_pos = next_ptr_pos
    Path(path).write_bytes(out.getvalue())


def read(path, upsampling: int = 1, frame_groups: int | None = None):
    """Read an EER file -> (n_frames, n, n) uint16 counts (optionally summed
    into `frame_groups` groups — the usual fractionation step)."""
    import struct

    with open(path, "rb") as f:
        header = f.read(8)
        endian = "<" if header[:2] == b"II" else ">"
        (ifd_offset,) = struct.unpack(endian + "I", header[4:8])
        frames = []
        while ifd_offset:
            tags, ifd_offset = tiff_mod._read_ifd(f, ifd_offset, endian)
            comp = tags.get(tiff_mod.TAG_COMPRESSION, (1,))[0]
            if comp not in (COMPRESSION_EER7, COMPRESSION_EER8):
                raise ValueError(f"not an EER page (compression {comp})")
            size = tags[tiff_mod.TAG_WIDTH][0]
            offsets = tags[tiff_mod.TAG_STRIP_OFFSETS]
            counts_b = tags[tiff_mod.TAG_STRIP_COUNTS]
            raw = b""
            for off, cnt in zip(offsets, counts_b):
                f.seek(off)
                raw += f.read(cnt)
            frames.append(decode_frame(raw, comp, size, upsampling))
    stack = np.stack(frames)
    if frame_groups and frame_groups < len(stack):
        per = len(stack) // frame_groups
        stack = np.stack([
            stack[i * per:(i + 1) * per].sum(axis=0)
            for i in range(frame_groups)
        ])
    return stack
