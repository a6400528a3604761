"""Build helper for the port's native code: shared libraries with a plain
C interface, loaded through ctypes, and host executables. Three routes:
the CUDA kernels (`csrc/<name>.cu`, nvcc for sm_90a), the host library
(`csrc/<name>.cpp`, the host C++ compiler, g++ unless `CXX` names
another) and the launcher executable (`csrc/<name>.cpp`, the same
compiler, `build_executable`).

Each source compiles at first use into
`pyp_tpu_torch/_build/lib<name>-<hash>.so` (an executable into
`_build/<name>-<hash>`), where `<hash>` is the source's content hash, so
an edited source rebuilds and an unchanged one loads the library already
built. Only the repository's own sources are compiled. A failed build
raises with the compiler's stderr.
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
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
EXE_FLAGS = ["-O2", "-std=c++17", "-Wall"]

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


def cxx_path() -> str:
    found = shutil.which(os.environ.get("CXX") or "g++")
    if found:
        return found
    raise RuntimeError("no host C++ compiler (g++ or $CXX) on PATH; the host "
                       "library cannot be built")


def source(name: str) -> Path:
    """csrc/<name>.cu (a CUDA kernel) or csrc/<name>.cpp (host code)."""
    for ext in (".cu", ".cpp"):
        if (CSRC / f"{name}{ext}").exists():
            return CSRC / f"{name}{ext}"
    raise FileNotFoundError(f"no csrc/{name}.cu or csrc/{name}.cpp")


def _digest(name: str) -> str:
    return hashlib.sha256(source(name).read_bytes()).hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def executable_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}"


def _compile(cmd: list[str], src: Path, out: Path) -> Path:
    """Run `cmd -o <tmp> src` and move the result to `out`, unless `out`
    exists."""
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent builds never
    # load a half-written file
    fd, tmp = tempfile.mkstemp(suffix=out.suffix, dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run(cmd + ["-o", tmp, str(src)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{Path(cmd[0]).name} failed building {src.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def build(name: str) -> Path:
    """Compile csrc/<name>.cu (nvcc) or csrc/<name>.cpp (the host
    compiler) unless the library for its current source exists; returns
    the library's path."""
    src = source(name)
    cmd = ([nvcc_path(), *NVCC_FLAGS] if src.suffix == ".cu"
           else [cxx_path(), *CXX_FLAGS])
    return _compile(cmd, src, library_path(name))


def build_executable(name: str) -> Path:
    """Compile csrc/<name>.cpp into an executable with the host compiler
    unless the one for its current source exists; returns its path."""
    out = _compile([cxx_path(), *EXE_FLAGS], source(name),
                   executable_path(name))
    out.chmod(0o755)
    return out


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu or .cpp, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _loaded[name] = lib
    return lib
