"""ctypes binding for the host library pypio (TIFF-LZW decode and section
copies), with the pure-Python routes where it is absent.

The port's own copy of pyp_tpu/io/native.py. The source is
`csrc/pypio.cpp` (a copy of the JAX package's native/pypio/pypio.cpp); it
compiles at first use with the host C++ compiler through `ops/_build` into
`pyp_tpu_torch/_build/`, never into the JAX package's tree. Where it cannot
be built or loaded the callers fall back to Python, as the JAX package's
do: this is host code, not a device kernel. `io/tiff` hands it every LZW
strip and counts which route decoded (`tiff.LZW_ROUTES`).
"""

from __future__ import annotations

import contextlib
import ctypes

from pyp_tpu_torch.utils import get_logger

logger = get_logger("native")

_LIB = None
_TRIED = False
_DISABLED = False


def _load():
    global _LIB, _TRIED
    if _DISABLED:
        return None
    if _TRIED:
        return _LIB
    _TRIED = True
    from pyp_tpu_torch.ops import _build

    try:
        lib = _build.load("pypio")
    except (RuntimeError, OSError) as e:
        logger.warning("native pypio unavailable (%s); using the Python "
                       "routes", str(e).splitlines()[0])
        return None
    lib.lzw_decode.restype = ctypes.c_long
    lib.lzw_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
    ]
    lib.copy_section.restype = ctypes.c_long
    lib.copy_section.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p, ctypes.c_long,
        ctypes.c_long,
    ]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


@contextlib.contextmanager
def python_only():
    """Within the block every caller takes its Python route, as where the
    library is absent (to time or test the two routes on one input)."""
    global _DISABLED
    saved, _DISABLED = _DISABLED, True
    try:
        yield
    finally:
        _DISABLED = saved


def lzw_decode(data: bytes, expected_size: int) -> bytes | None:
    """Native LZW decode; returns None if the library is unavailable (the
    caller falls back to the Python decoder)."""
    lib = _load()
    if lib is None:
        return None
    cap = max(expected_size, 4 * len(data) + 1024)
    out = (ctypes.c_uint8 * cap)()
    n = lib.lzw_decode(data, len(data), out, cap)
    if n < 0:
        return None
    return bytes(bytearray(out[:n]))


def copy_section(src_path, src_off, dst_path, dst_off, count) -> int:
    """Copy `count` bytes from `src_path` at `src_off` into `dst_path` at
    `dst_off` (the file is created if absent); returns the bytes copied."""
    lib = _load()
    if lib is None:
        import os

        if not os.path.exists(dst_path):
            open(dst_path, "wb").close()
        with open(src_path, "rb") as src, open(dst_path, "r+b") as dst:
            src.seek(src_off)
            dst.seek(dst_off)
            remaining = count
            while remaining:
                chunk = src.read(min(1 << 22, remaining))
                if not chunk:
                    break
                dst.write(chunk)
                remaining -= len(chunk)
            return count - remaining
    return lib.copy_section(
        str(src_path).encode(), src_off, str(dst_path).encode(), dst_off, count
    )
