"""The port's host code: `csrc/pypio.cpp` built with g++ through
`ops/_build` into `pyp_tpu_torch/_build/` (never into the JAX package's
native/pypio/), held to the Python LZW decoder and to `pyp_tpu.io.native`
byte for byte, `copy_section` on both routes, and `io.tiff` reading an LZW
movie through it, with the route that decoded counted; and the launcher
`csrc/launcher.cpp`, built as an executable the same way and held to
native/launcher/main.cpp as tests/test_native.py holds that one."""

import shutil
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pyp_tpu.io import native as jnative
from pyp_tpu.io import tiff as jtiff
from pyp_tpu_torch.io import native as tnative
from pyp_tpu_torch.io import tiff as ttiff
from pyp_tpu_torch.ops import _build

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_native import lzw_encode  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")


def _payloads():
    rng = np.random.RandomState(0)
    yield (rng.rand(20000) * 8).astype(np.uint8).tobytes()   # small alphabet
    yield rng.randint(0, 256, 9000, dtype=np.uint8).tobytes()  # table resets
    yield bytes(5000)                                          # one long run


def test_built_into_the_port_only():
    before = sorted(p.name for p in (REPO / "native" / "pypio").iterdir())
    assert tnative.available()
    lib = _build.library_path("pypio")
    assert lib.exists() and lib.parent == REPO / "pyp_tpu_torch" / "_build"
    assert sorted(p.name for p in (REPO / "native" / "pypio").iterdir()) \
        == before


@pytest.mark.parametrize("k", range(3))
def test_lzw_decode_matches_python_and_jax(k):
    payload = list(_payloads())[k]
    enc = lzw_encode(payload)
    out = tnative.lzw_decode(enc, len(payload))
    assert out == payload == ttiff._lzw_decode(enc)
    assert out == jnative.lzw_decode(enc, len(payload)) == jtiff._lzw_decode(enc)
    with tnative.python_only():
        assert not tnative.available()
        assert tnative.lzw_decode(enc, len(payload)) is None
    assert tnative.available()


def test_corrupt_stream_is_safe():
    out = tnative.lzw_decode(b"\xff\xff\xff\xff\xff\xff", 100)
    assert out is None or isinstance(out, bytes)


@pytest.mark.parametrize("route", ["native", "python"])
def test_copy_section(route, tmp_path):
    src = tmp_path / "src.bin"
    src.write_bytes(bytes(range(256)) * 40)
    for name, mod in (("port", tnative), ("jax", jnative)):
        dst = tmp_path / f"{name}.bin"
        dst.write_bytes(b"x" * 3000)
        if route == "python" and mod is tnative:
            with tnative.python_only():
                n = mod.copy_section(src, 17, dst, 5, 2000)
        else:
            n = mod.copy_section(src, 17, dst, 5, 2000)
        assert n == 2000
    assert (tmp_path / "port.bin").read_bytes() == \
        (tmp_path / "jax.bin").read_bytes()
    assert (tmp_path / "port.bin").read_bytes()[5:2005] == \
        src.read_bytes()[17:2017]
    # a destination that does not exist yet is created (the Python route)
    with tnative.python_only():
        assert tnative.copy_section(src, 0, tmp_path / "new.bin", 0, 10) == 10


def _lzw_tiff(path, pages):
    """A classic little-endian TIFF, one LZW strip per 8-bit page."""
    body, offsets = b"", []
    strips = [lzw_encode(p.tobytes()) for p in pages]
    ny, nx = pages[0].shape
    pos = 8
    for s in strips:
        offsets.append(pos)
        pos += len(s)
    ifds, ifd_pos = b"", pos
    for i, s in enumerate(strips):
        tags = [(256, 3, nx), (257, 3, ny), (258, 3, 8), (259, 3, 5),
                (273, 4, offsets[i]), (278, 4, ny), (279, 4, len(s))]
        nxt = ifd_pos + len(ifds) + 2 + 12 * len(tags) + 4
        ifds += struct.pack("<H", len(tags)) + b"".join(
            struct.pack("<HHII", t, typ, 1, v) for t, typ, v in tags
        ) + struct.pack("<I", nxt if i + 1 < len(strips) else 0)
    path.write_bytes(b"II" + struct.pack("<HI", 42, ifd_pos)
                     + b"".join(strips) + ifds)


def test_tiff_lzw_movie_reads_through_both_routes(tmp_path):
    rng = np.random.RandomState(3)
    pages = [rng.poisson(2.0, (48, 40)).astype(np.uint8) for _ in range(3)]
    path = tmp_path / "m.tif"
    _lzw_tiff(path, pages)
    routes = dict(ttiff.LZW_ROUTES)
    native = ttiff.read(path)
    assert ttiff.LZW_ROUTES["native"] - routes["native"] == 3
    with tnative.python_only():
        python = ttiff.read(path)
    assert ttiff.LZW_ROUTES["python"] - routes["python"] == 3
    np.testing.assert_array_equal(native, np.stack(pages))
    np.testing.assert_array_equal(python, native)
    np.testing.assert_array_equal(jtiff.read(path), native)


ALIASES = {"spr": "spr", "tomo": "tomo", "csp": "csp", "fyp": "refine",
           "byp": "byp", "pcl": "clean", "pex": "export_session",
           "ppp": "postprocess", "pmk": "mask", "psp": "postprocess",
           "gyp": "gain", "rlp": "import_star", "rln": "export_star",
           "wrp": "import_star", "sva": "sva", "3davg": "sva",
           "streampyp": "stream"}


def test_launcher_is_the_jax_packages_but_for_the_module(tmp_path):
    """csrc/launcher.cpp, the twin of native/launcher/main.cpp: the same
    source but for the module it execs and the name in its messages
    (and the build line and a cited path of its header comment), built
    with g++ into `_build/` (native/launcher/ untouched). Every alias, and
    a mode given as the first argument, execs `python -m pyp_tpu_torch.cli
    <mode> <args>`; here the python is a stub printing its argv."""
    jax = (REPO / "native" / "launcher" / "main.cpp").read_text()
    port = (REPO / "pyp_tpu_torch" / "csrc" / "launcher.cpp").read_text()
    differ = [(a, b) for a, b in zip(jax.splitlines(), port.splitlines())
              if a != b]
    assert len(jax.splitlines()) == len(port.splitlines())
    assert [b for _, b in differ] == [
        "// pyp_tpu_torch launcher — host-side entry binary.",
        "// (launcher/src/main.rs: read user config, wrap argv,",
        "//   3. exec `python -m pyp_tpu_torch.cli <mode> <args...>` with "
        "PYTHONPATH set.",
        "// Build: pyp_tpu_torch.ops._build.build_executable(\"launcher\")  "
        "->  _build/launcher-<hash>",
        '    execv_args.push_back(const_cast<char*>("pyp_tpu_torch.cli"));',
        '    std::cerr << "pyp_tpu_torch launcher: failed to exec " << python '
        '<< ": "']
    before = sorted(p.name for p in (REPO / "native" / "launcher").iterdir())
    binary = _build.build_executable("launcher")
    assert binary.parent == REPO / "pyp_tpu_torch" / "_build"
    assert sorted(p.name for p in (REPO / "native" / "launcher").iterdir()) \
        == before
    stub = tmp_path / "python"
    stub.write_text('#!/bin/sh\necho "$@"\n')
    stub.chmod(0o755)
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
           "PYP_TPU_PYTHON": str(stub)}
    for alias, mode in ALIASES.items():
        link = tmp_path / alias
        link.symlink_to(binary)
        out = subprocess.run([str(link), "-x", "1"], capture_output=True,
                             text=True, env=env)
        assert out.returncode == 0, out.stderr
        assert out.stdout.split() == ["-m", "pyp_tpu_torch.cli", mode, "-x",
                                      "1"]
    out = subprocess.run([str(binary), "worker", "p.json"],
                         capture_output=True, text=True, env=env)
    assert out.stdout.split() == ["-m", "pyp_tpu_torch.cli", "worker",
                                  "p.json"]
    env["PYP_TPU_PYTHON"] = str(tmp_path / "absent")
    out = subprocess.run([str(binary), "params"], capture_output=True,
                         text=True, env=env)
    assert out.returncode == 127
    assert "pyp_tpu_torch launcher: failed to exec" in out.stderr
