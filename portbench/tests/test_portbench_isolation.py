"""The benchmark imports neither JAX nor the JAX package, and its reference
and input generators import nothing of the system under test."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "pyp_tpu"}


def top_level_imports(path):
    """Top-level names (before the first dot) of every module a file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def sources(*parts):
    return sorted((BENCH.joinpath(*parts)).rglob("*.py"))


@pytest.mark.parametrize("path", sources(), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sources("reference") + sources("gen"),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_and_generators_import_nothing_of_the_system(path):
    assert "pyp_tpu_torch" not in top_level_imports(path)


def test_the_scan_sees_a_forbidden_import(tmp_path):
    """The whole-name comparison: pyp_tpu_torch is allowed, pyp_tpu is not."""
    f = tmp_path / "m.py"
    f.write_text("import pyp_tpu_torch.ops\nfrom pyp_tpu.core import fft\n")
    names = top_level_imports(f)
    assert names & FORBIDDEN == {"pyp_tpu"}
    assert "pyp_tpu_torch" in names
