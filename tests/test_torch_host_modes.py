"""The host modes of the port against the JAX package's: `params`,
`filter`, `boxedit`, `tomoedit`, `export_star` (SPA and tomo),
`import_star` (particles, tomograms, RELION-5 particles and motion stars),
`byp` (every extension branch: .box, .boxx, .mod, .mod -to_cbox, .cbox,
.star, .cistem, .cistem -refine_parfile_compress, and .mrc -to_hdf / .hdf
with h5py), `export_session` and `report`. Each runs through both
packages' `cli.main` on copies of one small project, in the same order;
then the two project trees hold the same files, byte for byte (bundles
compared by their arrays and scalars, a bz2 file by its text), and each
mode printed the same JSON."""

import bz2
import contextlib
import io
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest

from pyp_tpu import cli as jcli
from pyp_tpu.config import params as jparams
from pyp_tpu.io import boxfiles, cistem, imod, mrc, star
from pyp_tpu.io.metadata import ItemMetadata
from pyp_tpu_torch import cli as tcli


@pytest.fixture(autouse=True)
def _no_history(monkeypatch):
    # the JAX CLI appends every call to .pyp_history (the port keeps none)
    monkeypatch.setenv("PYP_TPU_NO_HISTORY", "1")
    monkeypatch.delenv("PYP_TPU_WEBHOST", raising=False)


def seed_project(root: Path):
    """Three micrographs' bundles, a tilt series' bundle, a particle table
    and stack, refinement curves and coordinate files of each kind."""
    rng = np.random.RandomState(0)
    root.mkdir(parents=True)
    for i, res in enumerate((5.0, 7.5, 12.0)):
        meta = ItemMetadata(f"m{i}", root, mode="spr")
        meta["ctf"] = np.array([15000.0 + 100 * i, 14000.0, 30.0 * i, 0.0,
                                0.9 - 0.1 * i, res])
        meta["drift"] = np.cumsum(rng.randn(6, 2), 0).astype(np.float32)
        box = np.c_[rng.uniform(40, 470, (12, 2)), rng.uniform(0, 1, 12)]
        meta["box"] = box.astype(np.float32)
        meta.scalars.update(pixel=1.5, voltage=300.0)
        meta.save()
    T = 9
    ts = ItemMetadata("ts1", root, mode="tomo")
    ts["tlt"] = np.linspace(-40, 40, T).astype(np.float32)
    ts["xf"] = np.c_[rng.randn(T, 2) * 4, np.full(T, 85.0)].astype(
        np.float32)
    ts["ctf"] = np.c_[rng.uniform(2e4, 3e4, (T, 2)), rng.uniform(0, 90, T),
                      np.zeros((T, 3))].astype(np.float32)
    ts["order"] = np.arange(T, dtype=np.float32)
    ts["vir"] = rng.uniform(0, 100, (2, 5)).astype(np.float32)
    ts.save()
    t = cistem.Table.zeros(10)
    t["position_in_stack"] = np.arange(1, 11)
    for k in ("phi", "theta", "psi"):
        t[k] = rng.uniform(-180, 180, 10)
    t["x_shift"], t["y_shift"] = rng.uniform(-4, 4, (2, 10))
    t["defocus_1"] = t["defocus_2"] = rng.uniform(1.2e4, 2.5e4, 10)
    t["original_x_position"], t["original_y_position"] = rng.uniform(
        30, 480, (2, 10))
    t["particle_group"] = np.repeat([1, 2], 5)
    t["occupancy"] = np.full(10, 100.0)
    cistem.write_parameters(t, root / "stack.cistem")
    mrc.write(rng.randn(10, 16, 16).astype(np.float32), root / "stack.mrc",
              pixel_size=1.5)
    coords = rng.uniform(20, 200, (6, 2))
    boxfiles.write_box(coords, 32, root / "mic.box")
    boxfiles.write_boxx(coords, 32, root / "mic2.boxx",
                        kept=[1, 0, 1, 1, 0, 1])
    imod.write_point_model(root / "picks.mod",
                           rng.uniform(0, 256, (7, 3)).astype(np.float32))
    imod.write_point_model(root / "tpicks.mod",
                           rng.uniform(0, 256, (5, 3)).astype(np.float32))
    star.write({"root": {"fields": {}, "loop": {
        "rlnMicrographName": np.array(["m0.mrc", "m2.mrc", "gone.mrc"],
                                      dtype=object),
        "rlnAccumMotionTotal": np.array([12.5, 30.0, 4.0]),
        "rlnAccumMotionEarly": np.array([5.0, 9.0, 1.0]),
        "rlnAccumMotionLate": np.array([7.5, 21.0, 3.0])}}},
        root / "motion.star")
    maps = root / "maps"
    maps.mkdir()
    freqs = np.linspace(0.01, 0.25, 30)
    for it in (2, 3):
        curve = 1.0 / (1.0 + np.exp((freqs - 0.1 * it) * 60))
        np.savetxt(maps / f"ds_r01_{it:02d}_fsc.txt",
                   np.stack([freqs, curve], 1))
    (maps / "ds_model_fit.txt").write_text("2 0.61 0 0 0\n3 0.72 0 0 0\n")
    (maps / "ds_r01_history.json").write_text(json.dumps([
        {"iteration": 2, "resolution": 8.1,
         "median_angular_change_deg": 12.0, "occupancies": [100.0]},
        {"iteration": 3, "resolution": 5.2,
         "median_angular_change_deg": 2.5, "occupancies": [100.0]}]))
    jparams.save_parameters({"data_set": "ds", "scope_pixel": 1.5,
                             "scope_voltage": 300.0, "scope_cs": 2.7,
                             "scope_wgh": 0.07}, root)


def _call(main, argv, cwd):
    here = os.getcwd()
    os.chdir(cwd)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
    finally:
        os.chdir(here)
    text, objs, i = buf.getvalue(), [], 0
    while "{" in text[i:]:       # every JSON object printed, in order
        obj, i = json.JSONDecoder().raw_decode(text, text.index("{", i))
        objs.append(obj)
    return rc, objs


def run_both(tmp_path, calls):
    """Each argv through the JAX CLI in jax/ and the port's on the CPU in
    port/, two copies of one seeded project; the return codes and printed
    JSON agree call by call. Returns the two project roots."""
    base = tmp_path / "seed"
    seed_project(base)
    roots = {k: tmp_path / k for k in ("jax", "port")}
    for root in roots.values():
        shutil.copytree(base, root)
    for argv in calls:
        j = _call(jcli.main, argv, roots["jax"])
        t = _call(lambda a: tcli.main(a, device="cpu"), argv, roots["port"])
        assert t == j, argv
        assert j[0] == 0, (argv, j)
    return roots["jax"], roots["port"]


def assert_same_trees(a: Path, b: Path):
    files = {p.relative_to(a) for p in a.rglob("*") if p.is_file()}
    assert files == {p.relative_to(b) for p in b.rglob("*") if p.is_file()}
    for rel in sorted(files):
        x, y = a / rel, b / rel
        if rel.name.endswith(".npz"):
            u, v = np.load(x), np.load(y)
            assert sorted(u.files) == sorted(v.files), rel
            for k in u.files:
                np.testing.assert_array_equal(u[k], v[k], err_msg=str(rel))
        elif rel.suffix == ".bz2":
            assert bz2.decompress(x.read_bytes()) == \
                bz2.decompress(y.read_bytes()), rel
        else:
            assert x.read_bytes() == y.read_bytes(), rel


EDITS = [
    ["params", "-extract_box", "32"],
    ["filter", "-filter_criteria", "ctf_res<10 drift>0",
     "-filter_name", "good", "-filter_exclude", "m1"],
    ["boxedit", "-edit_name", "m0", "-edit_remove_circle", "250:250:150"],
    ["boxedit", "-edit_name", "m1", "-edit_min_score", "0.5"],
    ["boxedit", "-edit_name", "m2", "-edit_import_box", "mic.box"],
    ["tomoedit", "-edit_name", "ts1", "-edit_exclude_tilts", "0:3,8",
     "-edit_drop_virions"],
    ["export_session", "-data_parent", "."],
    ["report"],
]

STARS = [
    ["export_star", "-export_location", "out"],
    ["import_star", "out/particles.star"],
    ["import_star", "-import_motion_star", "motion.star"],
    ["export_star", "-data_mode", "tomo", "-export_location", "tomo_out"],
    ["import_star", "tomo_out/tomograms.star"],
]

BYP = [
    ["byp", "mic.box"],
    ["byp", "mic2.boxx"],
    ["byp", "picks.mod", "-extract_box", "48"],
    ["byp", "tpicks.mod", "-to_cbox", "-convert_scaling", "2",
     "-convert_z", "128"],
    ["byp", "tpicks.cbox", "-convert_scaling", "2", "-convert_z", "128"],
    ["byp", "out/particles.star", "-extract_box", "24"],
    ["byp", "stack.cistem"],
    ["byp", "stack.cistem", "-refine_parfile_compress"],
]


@pytest.mark.parametrize("calls", [EDITS, STARS, BYP],
                         ids=["edits_session_report", "stars", "byp"])
def test_host_modes_write_what_jax_writes(calls, tmp_path):
    if calls is BYP:
        calls = [["export_star", "-export_location", "out"]] + calls
    a, b = run_both(tmp_path, calls)
    assert_same_trees(a, b)


def test_hdf_branches(tmp_path):
    pytest.importorskip("h5py")
    a, b = run_both(tmp_path, [["byp", "stack.mrc", "-to_hdf"],
                               ["byp", "stack.hdf"]])
    assert (b / "stack.hdf").exists()
    assert_same_trees(a, b)


def test_results_are_the_expected_ones(tmp_path):
    """What the port's modes wrote, read for its content (not only
    against JAX's): the RELION round trip keeps every pose and shift, the
    motion star lands in the matched bundles, the selection and the
    session export hold the right items."""
    _, b = run_both(tmp_path, EDITS + STARS)
    from pyp_tpu_torch.io import cistem as tcistem
    from pyp_tpu_torch.io.metadata import ItemMetadata as TMeta

    before = cistem.read_parameters(tmp_path / "seed" / "stack.cistem")
    after = tcistem.read_parameters(b / "stack.cistem")
    for k in ("phi", "theta", "psi", "x_shift", "y_shift", "defocus_1"):
        np.testing.assert_allclose(after[k], before[k], atol=1e-3)
    assert TMeta("m2", b).load().scalars["motion_total"] == 30.0
    assert "motion_total" not in TMeta("m1", b).load().scalars
    sel = json.loads((b / "ds_good.filter.json").read_text())
    assert sel["keep"] == ["m0"]       # m1 excluded, m2 at 12 Å
    ts = TMeta("ts1", b, mode="tomo").load()
    # tilts 0, 3 and 8 of nine dropped
    np.testing.assert_array_equal(ts["tlt"], [-30, -20, 0, 10, 20, 30])
    assert ts["vir"].shape == (0, 5)
    mics = star.read(b / "relion" / "ds_micrographs.star")
    # every bundle with a CTF fit, the tilt series' too
    assert list(mics["micrographs"]["loop"]["rlnMicrographName"]) == [
        "m0.mrc", "m1.mrc", "m2.mrc", "ts1.mrc"]
    assert "<table>" in (b / "ds_report.html").read_text()


def test_report_without_matplotlib_keeps_its_tables(tmp_path, monkeypatch):
    """Without matplotlib (the card machine has none) the port's report
    still writes the HTML with its tables and leaves the figures out."""
    import builtins

    from pyp_tpu_torch.analysis.report import build_report

    seed_project(tmp_path / "p")
    real = builtins.__import__

    def no_mpl(name, *a, **kw):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("No module named 'matplotlib'")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_mpl)
    out = Path(build_report(tmp_path / "p", "ds"))
    text = out.read_text()
    assert "<table>" in text and "m2" in text
    assert "data:image/png" not in text


PLOTS = ["plot_angular_distribution", "plot_defocus_histogram",
         "class_montage", "write_bild_angular_distribution",
         "plot_dataset_timeseries", "volume_montage"]


@pytest.mark.parametrize("name", PLOTS)
def test_plots_against_jax(name, tmp_path):
    """The plots the streaming slice adds: the .bild text and the montage
    sheet equal to JAX's (the sheet to 1e-6); the PNGs written by both,
    within 64 bytes of each other in size (the same figure)."""
    pytest.importorskip("matplotlib")
    from pyp_tpu.analysis import plots as jp
    from pyp_tpu_torch.analysis import plots as tp

    rng = np.random.RandomState(4)
    phi, theta = rng.uniform(0, 360, 200), rng.uniform(0, 180, 200)
    args = {"plot_angular_distribution": (phi, theta),
            "plot_defocus_histogram": (rng.uniform(1e4, 3e4, 50),
                                       rng.uniform(1e4, 3e4, 50)),
            "class_montage": (rng.randn(5, 16, 16),),
            "write_bild_angular_distribution": (phi, theta),
            "plot_dataset_timeseries": ({f"m{i}": {"defocus": 1e4 + i,
                                                   "drift": float(i)}
                                         for i in range(5)},),
            "volume_montage": (rng.randn(18, 16, 16),)}[name]
    kw = {"occupancy": [3, 1, 4, 1, 5]} if name == "class_montage" else {}
    ext = ".bild" if name.startswith("write_bild") else ".png"
    a, b = tmp_path / f"j{ext}", tmp_path / f"t{ext}"
    ja = getattr(jp, name)(*args, a, **kw)
    ta = getattr(tp, name)(*args, b, **kw)
    if name == "class_montage":
        np.testing.assert_allclose(ta, ja, atol=1e-6)
    if ext == ".bild":
        assert a.read_text() == b.read_text()
    else:
        assert abs(a.stat().st_size - b.stat().st_size) < 64


def test_notify_and_log(tmp_path):
    """utils.notify's JSONL spool (no pymongo) and mail through an injected
    SMTP class, and utils.log's TRACE level and file handler, as in the
    JAX package but under the port's logger root."""
    import logging

    from pyp_tpu_torch.utils import log as tlog
    from pyp_tpu_torch.utils import notify as tnotify

    spool = tmp_path / "spool.jsonl"
    sink = tnotify.attach_mongo_sink(str(spool), webid="w1")
    path = tmp_path / "run.log"
    handler = tlog.add_file_handler(path)
    logger = tlog.get_logger("notify_test")
    root = logging.getLogger("pyp_tpu_torch")
    level = root.level
    try:
        root.setLevel(tlog.TRACE)
        logger.trace("a trace line %d", 7)
        logger.info("an info line")
    finally:
        root.setLevel(level)
        root.removeHandler(sink)
        root.removeHandler(handler)
        handler.close()
    docs = [json.loads(ln) for ln in spool.read_text().splitlines()]
    assert [(d["level"], d["message"], d["webid"]) for d in docs] == [
        ("TRACE", "a trace line 7", "w1"), ("INFO", "an info line", "w1")]
    assert docs[0]["logger"] == "pyp_tpu_torch.notify_test"
    assert "TRACE pyp_tpu_torch.notify_test] a trace line 7" in path.read_text()
    sent = []

    class FakeSMTP:
        def __init__(self, host):
            sent.append(host)

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def send_message(self, msg):
            sent.append((msg["To"], msg["Subject"], msg.get_content().strip()))

    assert tnotify.send_email("a@b", "done", "body", smtp_host="mx",
                              smtp_factory=FakeSMTP)
    assert sent == ["mx", ("a@b", "done", "body")]
