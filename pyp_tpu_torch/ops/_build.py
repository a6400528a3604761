"""Build helper for the port's CUDA kernels (nvcc into a shared library
with a plain C interface, loaded through ctypes).

Each `csrc/<name>.cu` compiles at first use into
`pyp_tpu_torch/_build/lib<name>-<hash>.so`, where `<hash>` is the source's
content hash, so an edited source rebuilds and an unchanged one loads the
library already built. Only the repository's own sources are compiled. A
failed build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME/bin; the "
                       "CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless the library for its current source
    exists; returns the library's path."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent builds never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed building {name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _loaded[name] = lib
    return lib
