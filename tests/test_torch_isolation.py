"""The port stands alone: nothing under pyp_tpu_torch/, and not
chip_smoke.py, imports the JAX package, and the layers the port keeps its
own copies of (config, io, the CLI's project parameters) behave as the JAX
package's do: the same schema defaults and parsed flags, project files
and MRC / .cistem / PDB files each package reads back from the other,
byte for byte where both write, and STAR tables (the port keeps only the
reader) read the same. Also: the port's entry points default to the card,
so they raise on a machine without one."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from pyp_tpu import cli as jcli
from pyp_tpu.config import params as jparams
from pyp_tpu.config import schema as jschema
from pyp_tpu.io import cistem as jcistem
from pyp_tpu.io import mrc as jmrc
from pyp_tpu.io import pdb as jpdb
from pyp_tpu.io import star as jstar
from pyp_tpu.sched import bridge
from pyp_tpu_torch import cli as tcli
from pyp_tpu_torch.config import params as tparams
from pyp_tpu_torch.config import schema as tschema
from pyp_tpu_torch.io import cistem as tcistem
from pyp_tpu_torch.io import mrc as tmrc
from pyp_tpu_torch.io import pdb as tpdb
from pyp_tpu_torch.io import star as tstar

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(str(p.relative_to(REPO))
                    for p in (REPO / "pyp_tpu_torch").rglob("*.py")) + [
                        "chip_smoke.py"]

# refine, FRM and slurm_* flags, a bool negation and a schedule
ARGV = ["-refine_engine", "frm", "-refine_maxiter", "4", "-refine_rhref",
        "12:10:8:7", "-refine_dang", "7.5", "-refine_frm_cone", "15",
        "-refine_frm_wiener", "0.1", "-refine_goldstandard",
        "-no_plot_per_item", "-scope_pixel", "1.0", "-slurm_tasks", "8",
        "-slurm_queue", "gpu", "-slurm_memory", "64", "-particle_sym", "D7"]


def _imported_modules(path):
    tree = ast.parse((REPO / path).read_text(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_file_imports_nothing_of_pyp_tpu(path):
    bad = [m for m in _imported_modules(path)
           if m == "pyp_tpu" or m.startswith("pyp_tpu.") or m == "jax"
           or m.startswith("jax.")]
    assert not bad, f"{path} imports {bad}"


def test_schema_and_parsed_flags_agree():
    assert tschema.defaults() == jschema.defaults()
    tdefs, jdefs = tschema.all_params(), jschema.all_params()
    assert list(tdefs) == list(jdefs)
    assert all((tdefs[k].type, tdefs[k].enum, tdefs[k].schedule)
               == (jdefs[k].type, jdefs[k].enum, jdefs[k].schedule)
               for k in tdefs)
    assert tparams.parse_arguments(ARGV) == jparams.parse_arguments(ARGV)
    assert tparams.PROJECT_FILE == jparams.PROJECT_FILE


@pytest.mark.parametrize("writer,reader", [(tcli, jcli), (jcli, tcli)],
                         ids=["port_writes", "jax_writes"])
def test_project_file_reads_back_in_the_other_package(writer, reader,
                                                      tmp_path):
    written = writer._project_params(ARGV, work_dir=tmp_path)
    assert (tmp_path / tparams.PROJECT_FILE).exists()
    # a later run with no flags resumes from the project file
    assert reader._project_params([], work_dir=tmp_path) == written
    assert (reader._project_params(["-refine_maxiter", "6"],
                                   work_dir=tmp_path, persist=False)
            == {**written, "refine_maxiter": 6})


def test_slurm_and_modes_agree(monkeypatch):
    assert tcli.MODES == jcli.MODES
    params = tparams.parse_arguments(ARGV)
    for p in (params, tparams.parse_arguments([])):
        assert tcli.slurm_requested(p) == bridge.slurm_requested(p)
    assert tcli.slurm_requested(params)
    monkeypatch.setenv("PYP_TPU_WORKER", "1")
    assert not tcli.slurm_requested(params)
    assert not bridge.slurm_requested(params)


def test_web_request_is_the_same(monkeypatch):
    from pyp_tpu.stream import web as jweb
    from pyp_tpu_torch.stream import web as tweb

    sent = []

    class _Reply:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def read(self):
            return b'{"result": null}'

    def urlopen(req, timeout):
        sent.append((req.full_url, dict(req.header_items()), req.data))
        return _Reply()

    monkeypatch.setattr("urllib.request.urlopen", urlopen)
    args = ("ds", 3, np.float32(4.5), [1.0, 0.5, 0.1])
    for web in (jweb.Web("http://localhost:1", "t"),
                tweb.Web("http://localhost:1", "t")):
        assert web.exists
        assert web.write_reconstruction(*args) == {"result": None}
    assert len(sent) == 2 and sent[0] == sent[1]
    assert not tweb.Web("", "").exists


def _table(n=7, seed=0):
    rng = np.random.RandomState(seed)
    t = jcistem.Table.zeros(n)
    t["position_in_stack"] = np.arange(1, n + 1)
    for k in ("phi", "theta", "psi", "x_shift", "y_shift", "defocus_1",
              "defocus_2", "score"):
        t[k] = rng.uniform(-180, 180, n)
    return t


@pytest.mark.parametrize("what", ["mrc", "cistem", "pdb"])
def test_files_are_byte_identical_and_cross_read(what, tmp_path):
    rng = np.random.RandomState(1)
    paths = {p: tmp_path / f"{p}.{what}" for p in ("jax", "port")}
    if what == "pdb":
        xyz = rng.uniform(-50, 50, (9, 3)).astype(np.float32)
        elements = ["C", "N", "O", "S", "P", "FE", "ZN", "H", "MG"]
        bf = rng.uniform(0, 80, 9).astype(np.float32)
        jpdb.write_pdb(xyz, paths["jax"], elements=elements, bfactors=bf)
        tpdb.write_pdb(xyz, paths["port"], elements=elements, bfactors=bf)
        for path in paths.values():
            a, b = jpdb.read_pdb(path), tpdb.read_pdb(path)
            assert a["elements"] == b["elements"] == elements
            for k in ("coords", "weights", "bfactors"):
                np.testing.assert_array_equal(a[k], b[k])
    elif what == "mrc":
        vol = rng.randn(6, 8, 10).astype(np.float32)
        jmrc.write(vol, paths["jax"], pixel_size=1.3)
        tmrc.write(vol, paths["port"], pixel_size=1.3)
        for path in paths.values():
            np.testing.assert_array_equal(jmrc.read(path), vol)
            np.testing.assert_array_equal(tmrc.read(path), vol)
            assert tmrc.read_header(path).pixel_size == pytest.approx(1.3)
    else:
        table = _table()
        jcistem.write_parameters(table, paths["jax"])
        tcistem.write_parameters(
            tcistem.Table(list(table.column_ids), dict(table.data)),
            paths["port"])
        for path in paths.values():
            for read in (jcistem.read_parameters, tcistem.read_parameters):
                back = read(path)
                assert back.column_ids == table.column_ids
                for k in table.data:
                    np.testing.assert_array_equal(back[k], table[k])
    assert paths["jax"].read_bytes() == paths["port"].read_bytes()


def test_star_tables_read_the_same(tmp_path):
    """The port's copy of the STAR reader (what read_mtf_curve calls)
    parses what the JAX package writes as the JAX reader does."""
    path = tmp_path / "t.star"
    loop = {"rlnResolutionInversePixel": np.linspace(0.0, 0.5, 7),
            "rlnMtfValue": np.linspace(1.0, 0.2, 7),
            "rlnImageName": np.array([f"{i}@s.mrcs" for i in range(7)]),
            "rlnClassNumber": np.arange(7)}
    jstar.write({"mtf": {"fields": {"rlnVersion": "30001"}, "loop": loop},
                 "extra": {"fields": {"rlnPixel": "1.5"}, "loop": {}}}, path)
    a, b = jstar.read(path), tstar.read(path)
    assert list(a) == list(b) == ["mtf", "extra"]
    for name in a:
        assert a[name]["fields"] == b[name]["fields"]
        assert list(a[name]["loop"]) == list(b[name]["loop"])
        for col in a[name]["loop"]:
            assert a[name]["loop"][col].dtype == b[name]["loop"][col].dtype
            np.testing.assert_array_equal(a[name]["loop"][col], b[name]["loop"][col])


ENTRY_POINTS = ["refine_loop", "refinement_iteration", "reconstruct",
                "refine_batch", "FrmConfig", "postprocess_latest",
                "cli_postprocess", "cli_fsc", "cli_mask", "local_resolution",
                "model_map_fit"]


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_loop_entry_points_default_to_the_card(entry, tmp_path, monkeypatch):
    """Every entry point of the port defaults to "cuda" and raises through
    resolve_device where there is no card: none carries on on the CPU."""
    from pyp_tpu_torch.analysis import modelfit
    from pyp_tpu_torch.ops import frm, reconstruct, refine3d
    from pyp_tpu_torch.pipeline import refine as tref
    from pyp_tpu_torch.postprocess import core as post
    from pyp_tpu_torch.postprocess import locres

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    monkeypatch.chdir(tmp_path)
    params = tschema.defaults()
    params.update({"scope_pixel": 2.0, "refine_maxiter": 2})
    stack = np.zeros((2, 16, 16), np.float32)
    vol = np.zeros((16, 16, 16), np.float32)
    table = tcistem.Table.zeros(2)
    poses, cp = np.zeros((2, 5), np.float32), np.zeros((2, 4), np.float32)
    calls = {
        "refine_loop": lambda: tref.refine_loop(stack, table, vol, params,
                                                work_dir="unused"),
        "refinement_iteration": lambda: tref.refinement_iteration(
            stack, table, vol, params, 2),
        "reconstruct": lambda: reconstruct.reconstruct(stack, poses, cp, 2.0),
        "refine_batch": lambda: refine3d.refine_batch(stack, cp, vol, 2.0),
        "FrmConfig": lambda: frm.FrmConfig(16, 2.0),
        "postprocess_latest": lambda: post.postprocess_latest("ds", params),
        "cli_postprocess": lambda: tcli.main(["postprocess"]),
        "cli_fsc": lambda: tcli.main(["fsc", "a.mrc", "b.mrc"]),
        "cli_mask": lambda: tcli.main(["mask", "-model_path", "m.mrc"]),
        "local_resolution": lambda: locres.local_resolution(vol, vol, 2.0),
        "model_map_fit": lambda: modelfit.model_map_fit(
            {"coords": np.zeros((1, 3)), "weights": np.ones(1),
             "bfactors": np.zeros(1)}, vol, 2.0),
    }
    with pytest.raises(RuntimeError, match="cuda"):
        calls[entry]()
