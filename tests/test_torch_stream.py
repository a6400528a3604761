"""The session daemon of the port (`stream/daemon`, `SessionDaemon`,
`SessionManager`) and the `stream` mode against the JAX package's, on
the CPU, on three 3 x 96² movies with four dark blobs each (one shape, so
the JAX side compiles once). Both daemons run the same sequence and are
compared after each step: per-micrograph summaries, bundles, metadb
documents, the web push of the classes, the pypd.restart / pypd.clear /
pypd.stop flags, retention, the bz2 name, SessionManager's ledger and the
mdoc-less tilt assembly.

Tolerances: counts, names, files, flags, ledger and the summaries'
defocus, fit resolution and picks equal; the summaries' drift_px within
1e-4 px (the alignment's float32 sums in another order); the bundles as
test_torch_spr_pipeline.py holds them (drift 1e-3 px, the CTF vector to
its fit's resolution, picks as sets, the rest rtol 1e-3). The
incremental 2D classification is held as `test_torch_refine2d.py` holds
classify2d: assignments and occupancies equal (occupancies to 1e-4 %, as
float sums)."""

import contextlib
import io
import json
import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from pyp_tpu import cli as jcli
from pyp_tpu.config.params import defaults
from pyp_tpu.io import mrc
from pyp_tpu.io.metadata import ItemMetadata as JMeta
from pyp_tpu.stream import daemon as jd
from pyp_tpu.stream.metadb import MetaDB as JDB
from pyp_tpu_torch import cli as tcli
from pyp_tpu_torch.io.metadata import ItemMetadata as TMeta
from pyp_tpu_torch.stream import daemon as td
from pyp_tpu_torch.stream.metadb import MetaDB as TDB
from tests.test_torch_spr_pipeline import assert_bundles_agree

SIZE = 96
DRIFT_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    monkeypatch.delenv("PYP_TPU_WEBHOST", raising=False)
    monkeypatch.setenv("PYP_TPU_NO_HISTORY", "1")


def movie(path, seed):
    rng = np.random.RandomState(seed)
    img = rng.randn(3, SIZE, SIZE).astype(np.float32)
    yy, xx = np.mgrid[:SIZE, :SIZE]
    for cy, cx in ((30, 30), (30, 66), (66, 30), (66, 66)):
        img -= 4.0 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 18.0)[None]
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    mrc.write(img, str(path), pixel_size=1.0)


def params(root, **over):
    p = defaults()
    p.update({"scope_pixel": 1.0, "data_set": "sess", "ctf_tile": 64,
              "detect_rad": 6.0, "detect_max": 8, "extract_box": 32,
              "class_rhcls": 5.0, "class_num": 2, "plot_per_item": False,
              "stream_metadb": str(root / "db.json")})
    p.update(over)
    return p


def daemons(tmp_path, n_movies, classify_every=0, **over):
    """A JAX and a port daemon, each on its own copy of the movies."""
    out = {}
    for name, mod, kw in (("jax", jd, {}), ("port", td, {"device": "cpu"})):
        root = tmp_path / name
        for i in range(n_movies):
            movie(root / "in" / f"m{i}.mrc", i)
            # stagger the mtimes so "oldest" is m0 in both
            t = time.time() - (n_movies - i) * 3600
            os.utime(root / "in" / f"m{i}.mrc", (t, t))
        out[name] = mod.SessionDaemon(
            str(root / "in" / "*.mrc"), params(root, **over), work_dir=root,
            poll_interval=0.0, classify_every=classify_every, n_classes=2,
            **kw)
    return out["jax"], out["port"]


def assert_summaries_equal(j, t):
    assert len(j) == len(t)
    for a, b in zip(j, t):
        b = {k: v for k, v in b.items() if k != "frame_uploads"}
        assert a.keys() == b.keys()
        for k in a:
            if k == "drift_px":
                assert abs(a[k] - b[k]) < DRIFT_TOL
            else:
                assert a[k] == b[k], k


def assert_bundles_equal(jroot, troot, names):
    for name in names:
        a, b = JMeta(name, jroot).load(), TMeta(name, troot).load()
        assert a.exists() and b.exists(), name
        assert_bundles_agree(b, a)


def files(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file() and p.suffix != ".png"
                  and "metadb" not in p.name)


def test_daemon_classifies_and_pushes_like_jax(tmp_path, monkeypatch):
    """Two movies, the classification after both, the metadb documents and
    the web push of the classes; then a pypd.restart that changes a ctf_
    parameter, which re-runs CTF estimation alone: ctf_force drops the
    ctf entries of each bundle and no other, so the alignment and the
    picks resume."""
    j, t = daemons(tmp_path, 2, classify_every=2)
    j.run(max_iterations=1)
    t.run(max_iterations=1)
    assert_summaries_equal(j.summaries, t.summaries)
    assert_bundles_equal(j.work_dir, t.work_dir, ["m0", "m1"])
    jr, tr = j.class_result, t.class_result
    np.testing.assert_array_equal(tr.assignments.numpy(),
                                  np.asarray(jr.assignments))
    np.testing.assert_allclose(tr.occupancy.numpy(), np.asarray(jr.occupancy),
                               atol=1e-4)
    assert float(tr.occupancy.sum()) == pytest.approx(8.0)
    jdb, tdb = JDB(str(j.work_dir / "db.json")), TDB(str(t.work_dir / "db.json"))
    tsess = tdb.get_session("group", "sess")
    tsess["pattern"] = tsess["pattern"].replace("/port/", "/jax/")
    assert tsess == jdb.get_session("group", "sess")
    for a, b in zip(jdb.micrographs("group", "sess"),
                    tdb.micrographs("group", "sess")):
        assert_summaries_equal([{k: v for k, v in a.items() if k != "_id"}],
                               [{k: v for k, v in b.items() if k != "_id"}])
        assert a["_id"] == b["_id"]
    assert tdb.count_micrographs("group", "sess") == 2
    assert tdb.get_twod_classes("group", "sess") == pytest.approx(
        jdb.get_twod_classes("group", "sess"))
    jpush = [s for s in j._web.sent if s["method"] == "write_classes"]
    tpush = [s for s in t._web.sent if s["method"] == "write_classes"]
    assert json.loads(json.dumps(tpush).replace("/port/", "/jax/")) == jpush
    assert len(tpush) == 1
    assert (t.work_dir / "stream_classes.png").exists()

    drift = np.asarray(TMeta("m0", t.work_dir).load()["drift"])
    runs = {}
    for d in (j, t):
        (d.work_dir / "pypd.restart").write_text("ctf_max_res = 6.0\n")
        stages = []
        mod = "pyp_tpu" if d is j else "pyp_tpu_torch"
        monkeypatch.setattr(f"{mod}.pipeline.spr.Timer",
                            _recording_timer(stages))
        assert not d.check_flags()
        runs[d is t] = stages
        assert d.params["ctf_max_res"] == 6.0 and not d.params["ctf_force"]
        assert not (d.work_dir / "pypd.restart").exists()
    assert runs[True] == runs[False]
    assert "movie alignment" not in runs[True]
    assert runs[True] == ["CTF estimation"] * 2
    np.testing.assert_array_equal(
        np.asarray(TMeta("m0", t.work_dir).load()["drift"]), drift)
    assert_summaries_equal(j.summaries, t.summaries)
    assert_bundles_equal(j.work_dir, t.work_dir, ["m0", "m1"])


def _recording_timer(stages):
    @contextlib.contextmanager
    def timer(name, *a, **kw):
        stages.append(name)
        yield
    return timer


def test_compress_retention_clear_and_stop_like_jax(tmp_path):
    """stream_compress (the raw movie becomes <name>.mrc.bz2, the item
    keeps its name), retention of the two newest, pypd.clear (derived
    files wiped, everything kept reprocessed from the .bz2 files) and
    pypd.stop (consumed, the session marked stopped, nothing processed)."""
    j, t = daemons(tmp_path, 3, stream_compress=True,
                   stream_retention_max_items=2)
    for d in (j, t):
        d.run(max_iterations=1)
        assert (d.work_dir / "pypd.start").exists()
    assert_summaries_equal(j.summaries, t.summaries)
    assert files(t.work_dir) == files(j.work_dir)
    assert not (t.work_dir / "in" / "m0.mrc.bz2").exists()   # pruned
    assert (t.work_dir / "in" / "m2.mrc.bz2").exists()
    assert not (t.work_dir / "m0.meta.npz").exists()
    for d in (j, t):
        (d.work_dir / "pypd.clear").touch()
        assert not d.check_flags()
    assert [s["name"] for s in t.summaries] == ["m1", "m2"]
    assert_summaries_equal(j.summaries, t.summaries)
    assert files(t.work_dir) == files(j.work_dir)
    assert_bundles_equal(j.work_dir, t.work_dir, ["m1", "m2"])
    for d in (j, t):
        movie(d.work_dir / "in" / "m9.mrc", 9)
        (d.work_dir / "pypd.stop").touch()
        d.run(max_iterations=3)
        assert not (d.work_dir / "pypd.stop").exists()
        assert len(d.summaries) == 2
    assert TDB(str(t.work_dir / "db.json")).get_session("group", "sess") == \
        JDB(str(j.work_dir / "db.json")).get_session("group", "sess") == {
            "_id": "group/sess", "status": "stopped"}


def test_session_manager_ledger_like_jax(tmp_path):
    ledgers = {}
    for name, mod, kw in (("jax", jd, {}), ("port", td, {"device": "cpu"})):
        root = tmp_path / name
        for g, s in (("krios1", "sessA"), ("krios2", "sessB")):
            (root / g / s).mkdir(parents=True)
            (root / g / s / "session.toml").write_text('data_path = "*.mrc"\n')
            movie(root / g / s / "a.mrc", 1)
        (root / "g" / "bad").mkdir(parents=True)
        (root / "g" / "bad" / "session.toml").write_text(
            'data_path = "*.mrc"\nstream_classify_every = "nope"\n')
        mgr = mod.SessionManager(root, defaults=params(root), poll_interval=0,
                                 **kw)
        mgr.step()
        mgr.step()
        first = json.loads((root / "sessions.json").read_text())
        (root / "krios1" / "sessA" / "pypd.stop").touch()
        mgr.step()
        ledgers[name] = (first, json.loads((root / "sessions.json").read_text()),
                         sorted(mgr.daemons), sorted(mgr.retired))
    assert ledgers["port"] == ledgers["jax"]
    first, last, live, retired = ledgers["port"]
    assert first["krios1/sessA"]["items"] == first["krios2/sessB"]["items"] == 1
    assert last["krios1/sessA"] == {"status": "stopped"}
    assert live == [("krios2", "sessB")]
    assert retired == [("g", "bad"), ("krios1", "sessA")]


def test_mdocless_tilt_assembly_like_jax(tmp_path, monkeypatch):
    """stream_num_tilts / tilt_angles / tilt_order: the series goes to
    process_tilt_series once its three tilts have arrived, angles mapped
    through the acquisition order; the item each daemon assembles is the
    same (process_tilt_series itself is held to JAX in
    test_torch_tomo_pipeline.py)."""
    got = {}
    for name, mod, kw in (("jax", jd, {}), ("port", td, {"device": "cpu"})):
        seen = []
        pkg = "pyp_tpu" if name == "jax" else "pyp_tpu_torch"
        monkeypatch.setattr(
            f"{pkg}.pipeline.tomo.process_tilt_series",
            lambda item, p, w=".", **k: seen.append((item, k)) or {
                "name": item["name"], "particles": 0})
        root = tmp_path / name
        for i in range(3):
            movie(root / "in" / f"ts1_{i:03d}.mrc", 10 + i)
        d = mod.SessionDaemon(
            str(root / "in" / "*.mrc"),
            params(root, data_mode="tomo", stream_num_tilts=3,
                   stream_tilt_angles="-30,0,30", stream_tilt_order="1,0,2"),
            work_dir=root, poll_interval=0.0, **kw)
        d.run(max_iterations=1)
        got[name] = seen
    (jitem, _), = got["jax"]
    (titem, tkw), = got["port"]
    assert tkw == {"device": torch.device("cpu")}
    assert titem.keys() == jitem.keys() and titem["name"] == "ts1"
    np.testing.assert_array_equal(titem["angles"], [-30.0, 0.0, 30.0])
    for k in ("tilts", "angles", "order"):
        np.testing.assert_array_equal(np.asarray(titem[k]),
                                      np.asarray(jitem[k]))


def _cli(main, argv, cwd):
    here = os.getcwd()
    os.chdir(cwd)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
    finally:
        os.chdir(here)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    return rc, json.loads(lines[-1])


def test_stream_mode_like_jax(tmp_path):
    """`stream` through both CLIs, bounded as test_cli_modes.py bounds it;
    with the SLURM parameters the port writes the daemon's one job, as the
    JAX package does (refused until the SLURM slice)."""
    argv = ["stream", "-data_path", "in/*.mrc", "-stream_max_iterations",
            "2", "-stream_poll_interval", "0.01", "-scope_pixel", "1.0",
            "-ctf_tile", "64", "-detect_rad", "6", "-detect_max", "8",
            "-extract_box", "32", "-no_plot_per_item",
            "-stream_metadb", "db.json"]
    out = {}
    for name, main in (("jax", jcli.main),
                       ("port", lambda a: tcli.main(a, device="cpu"))):
        root = tmp_path / name
        for i in range(2):
            movie(root / "in" / f"s{i}.mrc", 20 + i)
        out[name] = _cli(main, argv, root)
    assert out["port"] == out["jax"] == (0, {"processed": 2,
                                             "classified": False})
    assert TDB(str(tmp_path / "port" / "db.json")).count_micrographs(
        "group", "session") == 2
    here = os.getcwd()
    os.chdir(tmp_path / "port")
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            assert tcli.main(argv + ["-slurm_queue", "gpu"],
                             device="cpu") == 0
    finally:
        os.chdir(here)
    daemon_job = (tmp_path / "port" / "swarm" / "streamdaemon.swarm")
    assert "-m pyp_tpu_torch.cli worker" in daemon_job.read_text()


def test_classes_pushed_without_a_montage(tmp_path, monkeypatch):
    """Without matplotlib (the card machine has none) the daemon skips the
    montage with a warning and pushes the occupancies with no image."""
    import pyp_tpu_torch.analysis.plots as tplots

    def no_pyplot(*a, **kw):
        raise ImportError("No module named 'matplotlib'")

    monkeypatch.setattr(tplots, "_pyplot", no_pyplot)
    root = tmp_path / "port"
    for i in range(2):
        movie(root / "in" / f"m{i}.mrc", i)
    d = td.SessionDaemon(str(root / "in" / "*.mrc"), params(root),
                         work_dir=root, poll_interval=0.0, classify_every=2,
                         n_classes=2, device="cpu")
    d.run(max_iterations=1)
    push, = [s for s in d._web.sent if s["method"] == "write_classes"]
    assert push["params"]["montage"] == ""
    assert sum(push["params"]["occupancy"]) == pytest.approx(8.0)
    assert not (root / "stream_classes.png").exists()
    assert TDB(str(root / "db.json")).get_twod_classes(
        "group", "sess")["particles"] == 8
