"""The port stands alone: nothing under pyp_tpu_torch/, and not
chip_smoke.py, imports the JAX package, and the layers the port keeps its
own copies of (config, io, the CLI's project parameters) behave as the JAX
package's do: the same schema defaults and parsed flags, project files
and MRC / .cistem / PDB files each package reads back from the other,
byte for byte where both write, and STAR tables read the same. Also: the
port's entry points default to the card, so they raise on a machine
without one, and its host modes take `device` and do no device work. The
preprocessing slice's copies (io.metadata, io.tiff, io.eer, io.dm,
sched.graph, LocalExecutor, load_selection, Web.write_micrograph) are held
to the JAX package's the same way (the SLURM parameters it refused now
route `spr` to the swarm scripts). The streaming slice's copies (the STAR writer, io.relion,
io.relion_tomo, io.parfile, io.warp, io.eman, analysis.filters,
stream.web, stream.params, stream.metadb, utils.notify and the pypio
source) are the JAX package's files but for the package's name."""

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
           if m.split(".")[0] in ("pyp_tpu", "jax", "flax", "optax")]
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
    assert set(tcli.PORTED) == set(tcli.MODES)
    params = tparams.parse_arguments(ARGV)
    for p in (params, tparams.parse_arguments([])):
        assert tcli.slurm_requested(p) == bridge.slurm_requested(p)
    assert tcli.slurm_requested(params)
    monkeypatch.setenv("PYP_TPU_WORKER", "1")
    assert not tcli.slurm_requested(params)
    assert not bridge.slurm_requested(params)


@pytest.mark.parametrize("method,args", [
    ("write_reconstruction", ("ds", 3, np.float32(4.5), [1.0, 0.5, 0.1])),
    ("write_micrograph", ("mic_01", {"particles": 12, "df1": np.float32(2e4),
                                     "ctf_fit_res": 4.5, "mag": 1e4})),
])
def test_web_request_is_the_same(monkeypatch, method, args):
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
    for web in (jweb.Web("http://localhost:1", "t"),
                tweb.Web("http://localhost:1", "t")):
        assert web.exists
        assert getattr(web, method)(*args) == {"result": None}
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


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_metadata_bundles_cross_read(writer, tmp_path):
    from pyp_tpu.io import metadata as jmeta
    from pyp_tpu_torch.io import metadata as tmeta

    assert tmeta.SCHEMA_SPR == jmeta.SCHEMA_SPR
    assert tmeta.SCHEMA_TOMO == jmeta.SCHEMA_TOMO
    rng = np.random.RandomState(2)
    arrays = {"drift": rng.randn(12, 2).astype(np.float32),
              "average": rng.randn(32, 48).astype(np.float32),
              "ctf": rng.randn(6), "box": rng.randn(5, 3)}
    W, R = (jmeta, tmeta) if writer == "jax" else (tmeta, jmeta)
    m = W.ItemMetadata("mic", tmp_path)
    for k, v in arrays.items():
        m[k] = v
    m.scalars.update(pixel=1.25, voltage=300.0)
    m.save()
    back = R.ItemMetadata("mic", tmp_path).load()
    assert back.exists() and back.scalars == m.scalars
    for k, v in arrays.items():
        assert back.is_done(k) and k in back
        np.testing.assert_array_equal(back[k], v)
        assert back[k].dtype == v.dtype
    assert not back.is_done("ctf_diag")
    assert sorted(back.refresh({"ctf_force": True, "movie_force": True})) == [
        "average", "ctf", "drift"]
    assert not back.is_done("drift") and back.is_done("box")
    back.save()                      # what was not dropped survives a save
    again = W.ItemMetadata("mic", tmp_path).load()
    np.testing.assert_array_equal(again["box"], arrays["box"])
    assert not again.is_done("ctf")
    # the scalar sidecars are the same bytes
    other = tmp_path / "other"
    m2 = R.ItemMetadata("mic", other)
    m2.scalars.update(m.scalars)
    m2["box"] = arrays["box"]
    m2.save()
    m.directory = tmp_path / "mine"
    m.save()
    assert m2.json_path.read_bytes() == m.json_path.read_bytes()


def test_port_metadata_reads_entries_on_demand(tmp_path):
    from pyp_tpu_torch.io.metadata import ItemMetadata

    m = ItemMetadata("mic", tmp_path)
    m["drift"], m["average"] = np.ones((3, 2)), np.zeros((8, 8))
    m.save()
    back = ItemMetadata("mic", tmp_path).load()
    assert back.arrays == {} and back.entries() == {"drift", "average"}
    assert back["drift"].shape == (3, 2) and set(back.arrays) == {"drift"}
    back["box"] = np.zeros((1, 3))
    back.save()
    assert ItemMetadata("mic", tmp_path).load().entries() == {
        "drift", "average", "box"}


@pytest.mark.parametrize("fmt", ["tiff8", "tiff16", "tiff_lzw", "eer", "dm4"])
def test_camera_formats_write_the_same_bytes_and_cross_read(fmt, tmp_path):
    from pyp_tpu.io import dm as jdm
    from pyp_tpu.io import eer as jeer
    from pyp_tpu.io import tiff as jtiff
    from pyp_tpu_torch.io import dm as tdm
    from pyp_tpu_torch.io import eer as teer
    from pyp_tpu_torch.io import tiff as ttiff

    rng = np.random.RandomState(3)
    a, b = tmp_path / "jax.bin", tmp_path / "port.bin"
    if fmt.startswith("tiff"):
        data = rng.poisson(3.0, (3, 20, 28)).astype(
            np.uint16 if fmt == "tiff16" else np.uint8)
        jtiff.write(data, a), ttiff.write(data, b)
        readers = (jtiff.read, ttiff.read)
        if fmt == "tiff_lzw":
            # an LZW-compressed page, hand-packed: 9-bit codes, clear first
            import struct

            raw = bytes(rng.randint(0, 200, 16, dtype=np.uint8))
            codes = [256] + list(raw) + [257]
            bits = "".join(f"{c:09b}" for c in codes)
            bits += "0" * (-len(bits) % 8)
            lzw = bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))
            tags = [(256, 3, 4), (257, 3, 4), (258, 3, 8), (259, 3, 5),
                    (273, 4, 8 + 2 + 12 * 7 + 4), (278, 3, 4),
                    (279, 4, len(lzw))]
            ifd = struct.pack("<H", len(tags)) + b"".join(
                struct.pack("<HHII", t, typ, 1, v) for t, typ, v in tags
            ) + struct.pack("<I", 0)
            a.write_bytes(b"II" + struct.pack("<HI", 42, 8) + ifd + lzw)
            b.write_bytes(a.read_bytes())
            data = np.frombuffer(raw, np.uint8).reshape(1, 4, 4)
    elif fmt == "eer":
        data = (rng.rand(4, 64, 64) < 0.02).astype(np.uint16)
        jeer.write(a, data), teer.write(b, data)
        readers = (lambda p: jeer.read(p, frame_groups=2),
                   lambda p: teer.read(p, frame_groups=2))
        data = data.reshape(2, 2, 64, 64).sum(1)
    else:
        data = rng.randn(3, 8, 12).astype(np.float32)
        jdm.write_dm4(data, a), tdm.write_dm4(data, b)
        readers = (jdm.read, tdm.read)
    assert a.read_bytes() == b.read_bytes()
    for read in readers:
        np.testing.assert_array_equal(np.asarray(read(a)), data)


@pytest.mark.parametrize("workers,fault_rate", [(1, 0.0), (3, 0.0), (1, 0.6)])
def test_job_graph_and_local_executor_behave_the_same(workers, fault_rate):
    from pyp_tpu import sched as jsched
    from pyp_tpu_torch import sched as tsched

    def run(mod):
        calls = []

        def work(item):
            calls.append(item)
            if item == "bad":
                raise ValueError("boom")
            return {"name": item, "n": len(item)}

        graph = mod.JobGraph("spr")
        graph.swarm("swarm", ["a", "bb", "bad", "cccc"], work_fn=work,
                    merge_fn=lambda results, missing: {
                        "done": sorted(results), "missing": sorted(missing)},
                    max_retries=2, merge_retries=1)
        mod.LocalExecutor(max_workers=workers, fault_rate=fault_rate,
                          fault_seed=4).run(graph)
        return ({n: (j.status, j.result, j.retries, sorted(j.deps))
                 for n, j in graph.jobs.items()}, sorted(calls),
                graph.is_complete())

    assert run(tsched) == run(jsched)
    jobs, calls, _ = run(tsched)
    assert jobs["swarm.merge"][0] == "done"
    assert jobs["swarm.merge"][1]["missing"] == [
        n for n, j in jobs.items() if j[0] == "failed"]
    if not fault_rate:
        assert calls.count("bad") == 3      # tried, then retried twice


def test_discover_bundles_is_the_same(tmp_path):
    """The port's copy of `discover_bundles` (what `prism` reads): the
    same function, the same names."""
    import inspect

    from pyp_tpu.analysis import filters as jf
    from pyp_tpu_torch.analysis import filters as tf

    assert inspect.getsource(tf.discover_bundles) == inspect.getsource(
        jf.discover_bundles)
    for name in ("b", "a", "c.x"):
        (tmp_path / f"{name}.meta.npz").write_bytes(b"")
    (tmp_path / "a.meta.json").write_text("{}")
    assert tf.discover_bundles(tmp_path) == jf.discover_bundles(tmp_path) == [
        "a", "b", "c.x"]


def test_load_selection_is_the_same(tmp_path):
    import json

    from pyp_tpu.analysis.filters import load_selection as jload
    from pyp_tpu_torch.analysis.filters import load_selection as tload

    (tmp_path / "ds_good.filter.json").write_text(
        json.dumps({"keep": ["a", "c"], "rules": []}))
    for arg in ("good", str(tmp_path / "ds_good.filter.json")):
        assert tload(arg, tmp_path, "ds") == jload(arg, tmp_path, "ds") == {"a", "c"}
    with pytest.raises(FileNotFoundError):
        tload("absent", tmp_path, "ds")


@pytest.mark.parametrize("flags,stage", [
    pytest.param(["-slurm_queue", "gpu"], "spr", id="flags0-SLURM"),
    pytest.param(["-slurm_submit"], "spr", id="flags1-SLURM"),
])
def test_refused_preprocessing_options_raise_by_name(flags, stage, tmp_path,
                                                     monkeypatch):
    """The SLURM parameters, refused until the SLURM slice, now route `spr`
    to the swarm scripts (sbatch is absent here, so -slurm_submit leaves
    them unsubmitted): the scripts are written, no bundle is."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("PYP_TPU_WORKER", raising=False)
    tmrc.write(np.zeros((2, 8, 8), np.float32), "m.mrc")
    assert tcli.main(["spr", "-data_path", "m.mrc"] + flags,
                     device="cpu") == 0
    for name in (f"{stage}swarm.sbatch", f"{stage}swarm.swarm",
                 f"{stage}merge.sbatch", f"{stage}_00000.json"):
        assert (tmp_path / "swarm" / name).exists(), name
    assert not list(tmp_path.glob("*.meta.npz"))


def _as_port(text):
    """A JAX-package file as the port copies it: its imports, its logger
    root, and the reference's sources cited without a machine's path."""
    return (text.replace("from pyp_tpu.", "from pyp_tpu_torch.")
            .replace("/root/reference/src/", "")
            .replace("to the pyp_tpu root", "to the pyp_tpu_torch root")
            .replace('logging.getLogger("pyp_tpu")',
                     'logging.getLogger("pyp_tpu_torch")'))


@pytest.mark.parametrize("rel", [
    "analysis/occupancies.py", "io/mdoc.py", "io/imod.py", "io/boxfiles.py",
    "analysis/fit.py", "io/star.py", "io/relion.py", "io/relion_tomo.py",
    "io/parfile.py", "io/warp.py", "io/eman.py", "analysis/filters.py",
    "stream/__init__.py", "stream/web.py", "stream/params.py",
    "stream/metadb.py", "utils/notify.py",
    "csrc/pypio.cpp:native/pypio/pypio.cpp"])
def test_copied_modules_are_byte_identical(rel):
    """The port's copies of JAX-free modules that it keeps unchanged, but
    for the package name in their imports (and the logger root and cited
    paths, `_as_port`); `port:jax` where the two paths differ."""
    port_rel, _, jax_rel = rel.partition(":")
    port = (REPO / "pyp_tpu_torch" / port_rel).read_text()
    jax = (REPO / jax_rel).read_text() if jax_rel else (
        REPO / "pyp_tpu" / rel).read_text()
    assert port == _as_port(jax), rel


@pytest.mark.parametrize("what", ["blocks", "geometry", "ctf", "artiax",
                                  "trajectories_plot", "slurm"])
def test_partial_copies_behave_the_same(what, tmp_path):
    """The parts of JAX-free (or JAX-light) modules the CSP slice copies:
    the csp block overrides and mode schedule, the rotation about x and the
    patch regions, the frame damage weights, the ArtiaX star (the same
    bytes) and the trajectory plot; and the SLURM slice's copies of
    sched/executor.py's SLURM half and sched/bridge.py: the same source
    but for the module the worker runs (the distributed script, which
    places one rank per card, is held in test_torch_bridge.py)."""
    if what == "slurm":
        import inspect

        from pyp_tpu.sched import executor as jexec
        from pyp_tpu_torch.sched import bridge as tbridge
        from pyp_tpu_torch.sched import executor as texec

        def src(obj):
            return inspect.getsource(obj).replace("pyp_tpu_torch.",
                                                  "pyp_tpu.")
        for name in ("get_total_seconds", "format_walltime",
                     "scale_walltime", "SlurmExecutor"):
            assert src(getattr(texec, name)) == src(getattr(jexec, name))
        for name in ("strip_slurm_flags", "_is_bool_flag", "slurm_requested",
                     "select_executor", "_payload", "worker_command",
                     "submit_training", "submit_daemon", "submit_swarm"):
            assert src(getattr(tbridge, name)) == src(getattr(bridge, name))
    elif what == "blocks":
        from pyp_tpu.config import blocks as jb
        from pyp_tpu_torch.config import blocks as tb

        for sw in [(a, b, c) for a in (0, 1) for b in (0, 1) for c in (0, 1)]:
            assert tb.block_mode_schedule(*sw) == jb.block_mode_schedule(*sw)
        base = {"class_num": 3, "class3d_refineeulers": 2,
                "class3d_refineshifts": 1}
        for block in jb.BLOCK_FIELDS:
            p = dict(base, **{f"{block}_{f}": (True if f.startswith("refine_")
                                               else 7)
                              for f in jb.BLOCK_FIELDS[block][:6]})
            assert tb.apply_block_overrides(p, block) == \
                jb.apply_block_overrides(p, block)
        with pytest.raises(ValueError):
            tb.apply_block_overrides({}, "csp_tomo_absent")
    elif what == "geometry":
        from pyp_tpu.core import geometry as jg
        from pyp_tpu_torch.core import geometry as tg

        a = np.linspace(-170, 170, 7).astype(np.float32)
        np.testing.assert_allclose(tg.rot_x(torch.as_tensor(a)).numpy(),
                                   np.asarray(jg.rot_x(a)), atol=1e-6)
        pts = np.random.RandomState(0).uniform(-5, 5, (40, 3))
        for grid in ((2, 2, 1), (3, 1, 2)):
            np.testing.assert_array_equal(
                tg.region_of(pts, -5, 5, grid), jg.region_of(pts, -5, 5, grid))
            for (a0, a1), (b0, b1) in zip(tg.divide_regions(-5, 5, grid),
                                          jg.divide_regions(-5, 5, grid)):
                np.testing.assert_array_equal(a0, b0)
                np.testing.assert_array_equal(a1, b1)
    elif what == "ctf":
        from pyp_tpu.core import ctf as jc
        from pyp_tpu_torch.core import ctf as tc

        ranks = np.linspace(0, 1, 5)
        for mult in (True, False):
            np.testing.assert_allclose(
                tc.frame_damage_weights((12, 16), ranks, 3.0, 0.5,
                                        mult).numpy(),
                np.asarray(jc.frame_damage_weights((12, 16), ranks, 3.0, 0.5,
                                                   mult)),
                rtol=1e-5, atol=1e-6)
    elif what == "artiax":
        from pyp_tpu.io import relion_tomo as jr
        from pyp_tpu_torch.io import relion_tomo as tr

        rng = np.random.RandomState(1)
        args = ("ts", rng.uniform(-50, 50, (4, 3)), rng.uniform(0, 360, (4, 3)),
                (32, 64, 64), 8)
        kw = dict(scores=rng.rand(4), classes=[1, 2, 1, 2])
        jr.export_artiax_star(*args, tmp_path / "j.star", **kw)
        tr.export_artiax_star(*args, tmp_path / "t.star", **kw)
        assert (tmp_path / "j.star").read_bytes() == \
            (tmp_path / "t.star").read_bytes()
    else:
        pytest.importorskip("matplotlib")
        from pyp_tpu.analysis import plots as jp
        from pyp_tpu_torch.analysis import plots as tp

        rng = np.random.RandomState(2)
        args = (rng.uniform(0, 64, (3, 2)), rng.randn(3, 5, 2), (64, 64))
        jp.plot_local_trajectories(*args, tmp_path / "j.png")
        tp.plot_local_trajectories(*args, tmp_path / "t.png")
        assert (tmp_path / "t.png").stat().st_size > 0
        assert abs((tmp_path / "t.png").stat().st_size
                   - (tmp_path / "j.png").stat().st_size) < 64


def test_tomography_files_read_the_same(tmp_path):
    """.mdoc, .xf, IMOD point models and coordinate files: what one
    package writes, both read the same, and the writers write the same
    bytes."""
    from pyp_tpu.io import boxfiles as jbox
    from pyp_tpu.io import imod as jimod
    from pyp_tpu.io import mdoc as jmdoc
    from pyp_tpu_torch.io import boxfiles as tbox
    from pyp_tpu_torch.io import imod as timod
    from pyp_tpu_torch.io import mdoc as tmdoc

    rng = np.random.RandomState(5)
    md = tmp_path / "ts.mrc.mdoc"
    md.write_text("PixelSpacing = 1.35\n\n" + "".join(
        f"[ZValue = {z}]\nTiltAngle = {a}\nExposureDose = 3.1\n"
        f"SubFramePath = X:\\frames\\ts_{z:03d}.tif\n"
        for z, a in enumerate((0.0, 3.0, -3.0))))
    a, b = jmdoc.read(md), tmdoc.read(md)
    assert a == b
    for f in ("tilt_angles", "exposure_doses", "subframe_paths"):
        assert getattr(jmdoc, f)(a) == getattr(tmdoc, f)(b)
    sh, rot = rng.randn(4, 2) * 5, rng.randn(4)
    jimod.write_xf(tmp_path / "j.xf", sh, rot)
    timod.write_xf(tmp_path / "t.xf", sh, rot)
    assert (tmp_path / "j.xf").read_bytes() == (tmp_path / "t.xf").read_bytes()
    for x, y in zip(jimod.read_xf(tmp_path / "t.xf"),
                    timod.read_xf(tmp_path / "j.xf")):
        np.testing.assert_array_equal(x, y)
    pts = rng.uniform(0, 60, (5, 3)).astype(np.float32)
    jimod.write_point_model(tmp_path / "j.mod", pts)
    timod.write_point_model(tmp_path / "t.mod", pts)
    assert (tmp_path / "j.mod").read_bytes() == (tmp_path / "t.mod").read_bytes()
    jbox.write_spk(pts, tmp_path / "j.spk")
    tbox.write_spk(pts, tmp_path / "t.spk")
    assert (tmp_path / "j.spk").read_bytes() == (tmp_path / "t.spk").read_bytes()
    np.testing.assert_array_equal(
        np.asarray(tbox.read_coords(str(tmp_path / "j.spk"))),
        np.asarray(jbox.read_coords(str(tmp_path / "j.spk"))))
    np.testing.assert_array_equal(timod.read_points(tmp_path / "j.mod"),
                                  jimod.read_points(tmp_path / "t.mod"))
    # a known defect of both copies: read_coords hands read_model's
    # (contours, header) pair to np.asarray, so a .mod import raises
    for mod in (jbox, tbox):
        with pytest.raises(ValueError):
            mod.read_coords(str(tmp_path / "j.mod"))


ENTRY_POINTS = ["refine_loop", "refinement_iteration", "reconstruct",
                "refine_batch", "FrmConfig", "postprocess_latest",
                "cli_postprocess", "cli_fsc", "cli_mask", "local_resolution",
                "model_map_fit", "process_micrograph", "extract_stack",
                "estimate_gain", "align_movie", "align_movie_large",
                "align_movie_patches", "fit_ctf", "fit_ctf_micrograph",
                "fit_ctf_local", "pick_particles", "detect_gold_beads",
                "extract_particles", "extract_from_frames", "cli_spr",
                "cli_extract", "cli_gain", "ab_initio", "ab_initio_frm",
                "mean_particle_score", "classify2d", "classify2d_staged",
                "classify3d_loop", "classify3d_iteration", "align_volumes",
                "cli_refine_abinit", "cli_classify2d", "cli_classify3d",
                "process_tilt_series", "assemble_tilt_series",
                "prealign_tilt_series", "track_patches", "track_beads",
                "align_tilt_series_fiducial", "wbp_reconstruct",
                "wbp_reconstruct_halves", "sart_reconstruct", "align_tilts",
                "ctf_correct_tilts", "detect_handedness", "ctf_deconvolve",
                "nlm_denoise_3d", "nad_denoise_3d", "denoise_map",
                "vesselness", "sheetness", "segment_membranes",
                "pick_filaments", "match_template_3d", "detect_spheres",
                "detect_spheres_template", "match_on_surface",
                "refine_virion_surface", "refine_surface_sh",
                "pick_particles_3d", "cli_tomo", "load_accumulators",
                "make_params", "csp_refine", "prepare_series_windows",
                "series_params_from_metadata", "csp_swarm_one",
                "csp_swarm_batch", "csp_refine_regions", "csp_classify",
                "csp_polish_frames", "refine_trajectories", "polish",
                "align_subvolumes", "refine_subvolumes", "center_subvolumes",
                "classify_subvolumes", "average_subvolumes", "sva_iterate",
                "cli_csp", "cli_polish", "cli_sva", "train_picker",
                "infer_heatmap", "pick_from_heatmap", "pick_tomogram",
                "train_denoiser", "denoise_image", "denoise_tomogram",
                "wedge_filter_2d", "wedge_filter_3d", "train_wedge_restorer",
                "restore_wedge", "train_membrane_segmenter",
                "segment_tomogram", "detect_virions_from_segmentation",
                "train_miner", "embed_patches", "mine_tomogram", "featurize",
                "train_quality", "embed_quality", "quality_scores",
                "train_heterogeneity", "train_heterogeneity_tilt", "embed",
                "embed_tilt", "decode_volume", "cli_sprtrain",
                "cli_tomotrain", "cli_mine", "cli_prism",
                "cli_heterogeneity", "SessionDaemon", "SessionManager",
                "run_workflow", "cli_stream", "cli_stream_sessions",
                "cli_workflow", "make_mesh", "init_distributed",
                "distributed_reconstruct", "cli_worker"]


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_loop_entry_points_default_to_the_card(entry, tmp_path, monkeypatch):
    """Every entry point of the port defaults to "cuda" and raises through
    resolve_device where there is no card: none carries on on the CPU."""
    from pyp_tpu_torch.analysis import modelfit
    from pyp_tpu_torch.io.metadata import ItemMetadata
    from pyp_tpu_torch.models import denoise as tden
    from pyp_tpu_torch.models import heterogeneity as thet
    from pyp_tpu_torch.models import membrane as tmem
    from pyp_tpu_torch.models import miner as tminer
    from pyp_tpu_torch.models import picker as tpick
    from pyp_tpu_torch.models import quality as tqual
    from pyp_tpu_torch import parallel
    from pyp_tpu_torch.parallel import multihost
    from pyp_tpu_torch.ops import (ab_initio, csp, ctf_fit, denoise_classic,
                                   extract, filament, frm, motion, pick,
                                   polish, reconstruct, refine2d, refine3d,
                                   sva, template_match, tomo)
    from pyp_tpu_torch.pipeline import csp as tcsp
    from pyp_tpu_torch.pipeline import tomo as ttomo
    from pyp_tpu_torch.pipeline import classify3d
    from pyp_tpu_torch.pipeline import refine as tref
    from pyp_tpu_torch.pipeline import spr as tspr
    from pyp_tpu_torch.postprocess import core as post
    from pyp_tpu_torch.postprocess import locres
    from pyp_tpu_torch.sched import workflow
    from pyp_tpu_torch.stream import daemon

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    monkeypatch.chdir(tmp_path)
    params = tschema.defaults()
    params.update({"scope_pixel": 2.0, "refine_maxiter": 2})
    stack = np.zeros((2, 16, 16), np.float32)
    vol = np.zeros((16, 16, 16), np.float32)
    table = tcistem.Table.zeros(2)
    poses, cp = np.zeros((2, 5), np.float32), np.zeros((2, 4), np.float32)
    tmrc.write(stack, "m.mrc")
    done = ItemMetadata("done", tmp_path)
    done["average"], done["box"] = stack[0], np.zeros((1, 3))
    done.save()
    coords = np.array([[8, 8]])
    ang, sh = [-30.0, 30.0], np.zeros((2, 2), np.float32)
    # the CSP inputs: params as CPU tensors, a series item
    cparams = csp.make_params(ang, ang, sh, poses[:, :3], poses[:, :3],
                              device="cpu")
    citem = {"name": "done", "tilts": stack, "coords": poses[:, :3],
             "eulers": poses[:, :3], "params": cparams, "defocus": sh}
    np.savez("acc.npz", **{k: np.zeros((2, 2, 2)) for k in
                           ("num1", "den1", "num2", "den2")})
    tmrc.write(stack, "stack.mrc")
    tcistem.write_parameters(table, "stack.cistem")
    (tmp_path / "spr.json").write_text(
        '{"mode": "spr", "argv": ["-data_path", "m.mrc"]}')
    # the models' entry points, on empty weights: each raises before it
    # reads them
    pmodel = tpick.PickerModel({}, 16, 2.0)
    dmodel = tden.DenoiseModel({}, 16)
    qmodel = tqual.QualityModel({}, 2, 8, np.zeros(2), np.ones(2))
    hmodel = thet.HetModel({}, {}, 2, 16, 2.0, np.zeros((3, 2), np.float32))
    calls = {
        "ab_initio": lambda: ab_initio.ab_initio(stack, cp, 2.0),
        "ab_initio_frm": lambda: ab_initio.ab_initio_frm(stack, cp, 2.0),
        "mean_particle_score": lambda: ab_initio.mean_particle_score(
            stack, cp, poses, vol, 2.0, 8.0),
        "classify2d": lambda: refine2d.classify2d(stack, cp, 2, 2.0),
        "classify2d_staged": lambda: refine2d.classify2d_staged(
            stack, cp, params, 2.0),
        "classify3d_loop": lambda: classify3d.classify3d_loop(
            stack, table, vol, params, work_dir="unused"),
        "classify3d_iteration": lambda: classify3d.classify3d_iteration(
            stack, table, [vol, vol], np.full((2, 2), 50.0), params, 2),
        "align_volumes": lambda: template_match.align_volumes(vol, vol),
        "cli_refine_abinit": lambda: tcli.main(["refine", "-refine_abinit"]),
        "cli_classify2d": lambda: tcli.main(["classify2d"]),
        "cli_classify3d": lambda: tcli.main(["classify3d"]),
        "process_micrograph": lambda: tspr.process_micrograph(
            {"name": "m", "frames": stack}, params),
        "extract_stack": lambda: tspr.extract_stack(["done"], params),
        "estimate_gain": lambda: tspr.estimate_gain(["m.mrc"]),
        "align_movie": lambda: motion.align_movie(stack),
        "align_movie_large": lambda: motion.align_movie_large(stack),
        "align_movie_patches": lambda: motion.align_movie_patches(stack, (2, 2)),
        "fit_ctf": lambda: ctf_fit.fit_ctf(stack[0, :, :9], 2.0),
        "fit_ctf_micrograph": lambda: ctf_fit.fit_ctf_micrograph(stack[0], 2.0),
        "fit_ctf_local": lambda: ctf_fit.fit_ctf_local(stack[0], 2.0),
        "pick_particles": lambda: pick.pick_particles(stack[0]),
        "detect_gold_beads": lambda: pick.detect_gold_beads(stack[0]),
        "extract_particles": lambda: extract.extract_particles(stack[0], coords, 8),
        "extract_from_frames": lambda: extract.extract_from_frames(stack, coords, 8),
        "cli_spr": lambda: tcli.main(["spr", "-data_path", "m.mrc"]),
        "cli_extract": lambda: tcli.main(["extract"]),
        "cli_gain": lambda: tcli.main(["gain", "-data_path", "m.mrc"]),
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
        "process_tilt_series": lambda: ttomo.process_tilt_series(
            {"name": "ts", "tilts": stack, "angles": [-30.0, 30.0]}, params),
        "assemble_tilt_series": lambda: ttomo.assemble_tilt_series(
            "absent.mdoc", params),
        "prealign_tilt_series": lambda: tomo.prealign_tilt_series(stack, ang),
        "track_patches": lambda: tomo.track_patches(stack, sh, ang, coords, 8),
        "track_beads": lambda: tomo.track_beads(stack, sh, ang, coords),
        "align_tilt_series_fiducial": lambda: tomo.align_tilt_series_fiducial(
            stack, ang),
        "wbp_reconstruct": lambda: tomo.wbp_reconstruct(stack, ang),
        "wbp_reconstruct_halves": lambda: tomo.wbp_reconstruct_halves(
            stack, ang),
        "sart_reconstruct": lambda: tomo.sart_reconstruct(stack, ang),
        "align_tilts": lambda: tomo.align_tilts(stack, sh, 3.0),
        "ctf_correct_tilts": lambda: tomo.ctf_correct_tilts(
            stack, ang, [2e4, 2e4], 2.0),
        "detect_handedness": lambda: tomo.detect_handedness(
            stack, ang, [2e4, 2e4], 2.0, min_tilt=0.0),
        "ctf_deconvolve": lambda: tomo.ctf_deconvolve(vol, 2e4, 2.0),
        "nlm_denoise_3d": lambda: denoise_classic.nlm_denoise_3d(vol),
        "nad_denoise_3d": lambda: denoise_classic.nad_denoise_3d(vol),
        "denoise_map": lambda: denoise_classic.denoise_map(vol),
        "vesselness": lambda: filament.vesselness(vol, 1.0),
        "sheetness": lambda: filament.sheetness(vol, 1.0),
        "segment_membranes": lambda: filament.segment_membranes(vol),
        "pick_filaments": lambda: filament.pick_filaments(vol, 2.0, 4.0),
        "match_template_3d": lambda: template_match.match_template_3d(
            vol, vol[:4, :4, :4], np.zeros((1, 3))),
        "detect_spheres": lambda: template_match.detect_spheres(vol, [3.0]),
        "detect_spheres_template": lambda:
            template_match.detect_spheres_template(vol, [3.0]),
        "match_on_surface": lambda: template_match.match_on_surface(
            vol, vol[:4, :4, :4], np.full((1, 3), 8.0), np.eye(3)[:1]),
        "refine_virion_surface": lambda: template_match.refine_virion_surface(
            vol, [8, 8, 8], 4.0),
        "refine_surface_sh": lambda: template_match.refine_surface_sh(
            vol, [8, 8, 8], 4.0),
        "pick_particles_3d": lambda: ttomo.pick_particles_3d(
            vol, {**params, "tomo_spk_method": "auto"}, 8.0),
        "cli_tomo": lambda: tcli.main(["tomo", "-data_path", "m.mrc"]),
        "load_accumulators": lambda: reconstruct.load_accumulators("acc.npz"),
        "make_params": lambda: csp.make_params(ang, ang, sh, poses[:, :3],
                                               poses[:, :3]),
        "csp_refine": lambda: csp.csp_refine(cparams, stack, sh, vol, 2.0, 8),
        "prepare_series_windows": lambda: csp.prepare_series_windows(
            stack, cparams, 8, np.zeros((3, 2))),
        "series_params_from_metadata": lambda: tcsp.series_params_from_metadata(
            done, poses[:, :3], poses[:, :3]),
        "csp_swarm_one": lambda: tcsp.csp_swarm_one(citem, params, vol),
        "csp_swarm_batch": lambda: tcsp.csp_swarm_batch([citem], params, vol),
        "csp_refine_regions": lambda: tcsp.csp_refine_regions(
            cparams, stack, sh, vol, 2.0, 8),
        "csp_classify": lambda: tcsp.csp_classify([citem], params, [vol]),
        "csp_polish_frames": lambda: tcsp.csp_polish_frames(
            [stack], cparams, sh, vol, params),
        "refine_trajectories": lambda: polish.refine_trajectories(
            stack[:, None], poses, cp, None, np.zeros((3, 2)), 16, 2.0),
        "polish": lambda: polish.polish(stack, coords, poses[:1], cp[:1],
                                        vol, 2.0, 8),
        "align_subvolumes": lambda: sva.align_subvolumes(vol[None], vol),
        "refine_subvolumes": lambda: sva.refine_subvolumes(
            vol[None], vol, np.zeros((1, 3)), np.zeros((1, 3)), 10.0, 5.0),
        "center_subvolumes": lambda: sva.center_subvolumes(vol[None]),
        "classify_subvolumes": lambda: sva.classify_subvolumes(
            vol[None], np.zeros((1, 3)), np.zeros((1, 3)), 1),
        "average_subvolumes": lambda: sva.average_subvolumes(
            vol[None], np.zeros((1, 3)), np.zeros((1, 3))),
        "sva_iterate": lambda: sva.sva_iterate(vol[None]),
        "cli_csp": lambda: tcli.main(["csp", "-data_path", "m.mrc"]),
        "cli_polish": lambda: tcli.main(["polish"]),
        "cli_sva": lambda: tcli.main(["sva"]),
        "train_picker": lambda: tpick.train_picker([stack[0]], [coords], 2.0,
                                                   patch=16),
        "infer_heatmap": lambda: tpick.infer_heatmap(pmodel, stack[0]),
        "pick_from_heatmap": lambda: tpick.pick_from_heatmap(stack[0], 2),
        "pick_tomogram": lambda: tpick.pick_tomogram(pmodel, vol, 2),
        "train_denoiser": lambda: tden.train_denoiser([stack[0]], [stack[1]],
                                                      patch=16),
        "denoise_image": lambda: tden.denoise_image(dmodel, stack[0]),
        "denoise_tomogram": lambda: tden.denoise_tomogram(dmodel, vol),
        "wedge_filter_2d": lambda: tden.wedge_filter_2d(stack[0], 60.0),
        "wedge_filter_3d": lambda: tden.wedge_filter_3d(vol, 60.0),
        "train_wedge_restorer": lambda: tden.train_wedge_restorer(
            [vol], 60.0, patch=16),
        "restore_wedge": lambda: tden.restore_wedge(
            tden.DenoiseModel({"net": {}, "tilt_max": 60.0}, 16), vol),
        "train_membrane_segmenter": lambda: tmem.train_membrane_segmenter(
            patch=16),
        "segment_tomogram": lambda: tmem.segment_tomogram(
            tmem.MembraneModel({}), vol),
        "detect_virions_from_segmentation": lambda:
            tmem.detect_virions_from_segmentation(vol, [3.0]),
        "train_miner": lambda: tminer.train_miner([vol], patch=8),
        "embed_patches": lambda: tminer.embed_patches(
            tminer.MinerModel({}, 8, 4), vol[None, :8, :8, :8]),
        "mine_tomogram": lambda: tminer.mine_tomogram(
            tminer.MinerModel({}, 8, 4), vol),
        "featurize": lambda: tqual.featurize(stack, 8),
        "train_quality": lambda: tqual.train_quality(stack, 8),
        "embed_quality": lambda: tqual.embed_quality(qmodel, stack),
        "quality_scores": lambda: tqual.quality_scores(qmodel, stack),
        "train_heterogeneity": lambda: thet.train_heterogeneity(
            stack, poses, cp, 2.0),
        "train_heterogeneity_tilt": lambda: thet.train_heterogeneity_tilt(
            stack[None], poses[None], cp[None], 2.0),
        "embed": lambda: thet.embed(hmodel, stack),
        "embed_tilt": lambda: thet.embed_tilt(hmodel, stack[None]),
        "decode_volume": lambda: thet.decode_volume(hmodel, np.zeros(2)),
        "cli_sprtrain": lambda: tcli.main(["sprtrain"]),
        "cli_tomotrain": lambda: tcli.main(["tomotrain"]),
        "cli_mine": lambda: tcli.main(["mine"]),
        "cli_prism": lambda: tcli.main(["prism"]),
        "cli_heterogeneity": lambda: tcli.main(["heterogeneity"]),
        "SessionDaemon": lambda: daemon.SessionDaemon("in/*.mrc", params),
        "SessionManager": lambda: daemon.SessionManager("sessions"),
        "run_workflow": lambda: workflow.run_workflow("wf.toml", {}),
        "cli_stream": lambda: tcli.main(["stream", "-data_path", "in/*.mrc"]),
        "cli_stream_sessions": lambda: tcli.main(
            ["stream", "-stream_sessions_dir", "sessions"]),
        "cli_workflow": lambda: tcli.main(["workflow", "wf.toml"]),
        "make_mesh": lambda: parallel.make_mesh(),
        "init_distributed": lambda: parallel.init_distributed(
            "localhost:1", 1, 0),
        "distributed_reconstruct": lambda: multihost.distributed_reconstruct(
            stack, poses, cp, 2.0),
        "cli_worker": lambda: tcli.main(["worker", "spr.json"]),
    }
    with pytest.raises(RuntimeError, match="cuda"):
        calls[entry]()


HOST_MODES = {"import_star": ["none.star"], "export_star": [],
              "params": [], "filter": [], "byp": ["m.box"],
              "boxedit": ["-edit_name", "m"],
              "tomoedit": ["-edit_name", "m"], "export_session": [],
              "report": []}


@pytest.mark.parametrize("mode", sorted(HOST_MODES))
def test_host_modes_take_device_and_do_no_device_work(mode, tmp_path,
                                                      monkeypatch):
    """The nine host modes take `device` ("cuda" by default, as every
    mode) and run with it where there is no card: none reaches the card."""
    import inspect

    from pyp_tpu_torch.io.metadata import ItemMetadata

    assert inspect.signature(tcli.PORTED[mode]).parameters[
        "device"].default == "cuda"
    assert set(tcli.PORTED) == set(tcli.MODES)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "none.star").write_text("data_\nloop_\n_rlnX #1\n1\n")
    tcistem.write_parameters(tcistem.Table.zeros(2), "stack.cistem")
    (tmp_path / "m.box").write_text("10\t20\t64\t64\n")
    meta = ItemMetadata("m", tmp_path)
    meta["ctf"] = np.array([1e4, 1e4, 0.0, 0.0, 0.5, 6.0])
    meta["box"] = np.array([[30.0, 40.0, 1.0]])
    meta.save()
    assert tcli.main([mode] + HOST_MODES[mode]) == 0
