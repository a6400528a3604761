"""The preprocessing slice as a whole on the CPU: one small movie (12 frames
of 256², a planted drift) through `process_micrograph` and `extract_stack`
of both packages, the `.meta.npz` bundles and the `.cistem` table compared,
each package resuming from the other's bundle, the pipeline's options, and
the `spr`, `extract` and `gain` modes through `cli.main(..., device="cpu")`.

Tolerances: drift within 1e-3 px; averages, spectra tables and particle
stacks rtol 1e-3 with atol 1e-4 * max|reference|; the CTF vector: defocus
within 0.2 * ctf_fstep, angle within 2°, cc and fit_res within 1e-3
relative (test_torch_ctf_fit.py says why); picks as sets of (y, x), scores
within 1e-3. The last test plants a drift, a CTF and particles with
`tools/e2e_spr` and holds the port alone to them.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from pyp_tpu import cli as jcli
from pyp_tpu.io import cistem as jcistem
from pyp_tpu.io import mrc as jmrc
from pyp_tpu.io.metadata import ItemMetadata as JMeta
from pyp_tpu.pipeline import spr as jspr
from pyp_tpu_torch import cli as tcli
from pyp_tpu_torch.config import schema
from pyp_tpu_torch.io.metadata import ItemMetadata as TMeta
from pyp_tpu_torch.pipeline import spr as tspr
from tests.test_torch_motion import make_movie

BASE = dict(scope_pixel=1.0, detect_rad=16.0, extract_box=32, ctf_tile=128,
            plot_per_item=False)


def close(port, ref, rtol=1e-3, atol_rel=1e-4):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    atol = atol_rel * max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol)


def params_with(**kw):
    p = schema.defaults()
    p.update(BASE)
    p.update(kw)
    return p


def assert_ctf_agree(out, ref, fstep=250.0):
    assert abs(out[0] - ref[0]) <= 0.2 * fstep and abs(out[1] - ref[1]) <= 0.2 * fstep, (out, ref)
    if ref[0] - ref[1] > 200.0:
        assert abs((out[2] - ref[2] + 90) % 180 - 90) <= 2.0, (out, ref)
    np.testing.assert_allclose(out[3:], ref[3:], rtol=1e-3, atol=1e-3)


def assert_bundles_agree(port, ref, skip=()):
    assert port.entries() == set(ref.arrays)
    for key in sorted(set(ref.arrays) - set(skip)):
        a, b = port[key], ref[key]
        assert a.dtype == b.dtype, (key, a.dtype, b.dtype)
        if key == "ctf":
            assert_ctf_agree(a, b)
        elif key == "box":
            assert {(y, x) for y, x, _ in a} == {(y, x) for y, x, _ in b}
            np.testing.assert_allclose(np.sort(a[:, 2]), np.sort(b[:, 2]),
                                       atol=1e-3)
        elif key in ("drift", "patch_shifts"):
            np.testing.assert_allclose(a, b, atol=5e-3 if key == "patch_shifts" else 1e-3)
        elif key == "ctf_diag":
            # the model half holds sin² of float32 phases of hundreds of
            # radians, and follows each package's own fit
            assert a.shape == b.shape
        elif key in ("ctf_plane", "ctf_thickness"):
            np.testing.assert_allclose(a[0], b[0], atol=60.0)
        else:
            close(a, b)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def movie():
    return make_movie(n=256)[0]


@pytest.fixture(scope="module")
def both(movie, tmp_path_factory):
    """The default pipeline run once in each package: (params, jax dir,
    port dir, jax summary, port summary)."""
    root = tmp_path_factory.mktemp("spr")
    params = params_with()
    jd, td = root / "jax", root / "port"
    sj = jspr.process_micrograph({"name": "m", "frames": movie}, params, jd)
    st = tspr.process_micrograph({"name": "m", "frames": movie}, params, td,
                                 device="cpu")
    return params, jd, td, sj, st


def test_process_micrograph_matches_jax(both):
    params, jd, td, sj, st = both
    assert st.pop("frame_uploads") == 1
    assert sj.keys() == st.keys() and sj["particles"] == st["particles"] > 0
    assert abs(sj["drift_px"] - st["drift_px"]) < 1e-2
    assert_bundles_agree(TMeta("m", td).load(), JMeta("m", jd).load())
    assert json.loads((td / "m.meta.json").read_text()) == json.loads(
        (jd / "m.meta.json").read_text())


def test_extract_stack_matches_jax(both):
    params, jd, td, _, _ = both
    stack_j, table_j = jspr.extract_stack([{"name": "m"}], params, jd)
    stack_t, table_t = tspr.extract_stack([{"name": "m"}], params, td,
                                          device="cpu")
    close(stack_t, stack_j)
    assert table_t.column_ids == table_j.column_ids
    for key in table_j.data:
        if key in ("defocus_1", "defocus_2"):
            np.testing.assert_allclose(table_t[key], table_j[key], atol=50.0)
        elif key == "defocus_angle":
            assert np.abs((table_t[key] - table_j[key] + 90) % 180 - 90).max() <= 2.0
        else:
            np.testing.assert_array_equal(table_t[key], table_j[key])
    # each package reads the other's files
    back = jcistem.read_parameters(td / "stack.cistem")
    np.testing.assert_array_equal(back["original_x_position"],
                                  table_t["original_x_position"])
    close(jmrc.read(td / "stack.mrc"), stack_t, rtol=0, atol_rel=0)


def test_port_resumes_from_the_jax_bundle(both, tmp_path):
    params, jd, _, sj, _ = both
    for f in jd.glob("m.meta.*"):
        (tmp_path / f.name).write_bytes(f.read_bytes())
    stamp = (tmp_path / "m.meta.npz").stat().st_mtime_ns
    # nothing to do: no frames are asked for, the bundle is not rewritten
    s = tspr.process_micrograph({"name": "m"}, params, tmp_path, device="cpu")
    assert s["frame_uploads"] == 0 and s["particles"] == sj["particles"]
    assert s["df1"] == sj["df1"] and s["ctf_fit_res"] == sj["ctf_fit_res"]
    assert (tmp_path / "m.meta.npz").stat().st_mtime_ns == stamp
    # CTF and picks forced: redone from the JAX package's average
    s = tspr.process_micrograph({"name": "m"}, {**params, "ctf_force": True,
                                                "detect_force": True},
                                tmp_path, device="cpu")
    assert s["frame_uploads"] == 0
    assert (tmp_path / "m.meta.npz").stat().st_mtime_ns != stamp
    ref = JMeta("m", jd).load()
    got = JMeta("m", tmp_path).load()          # the JAX reader reads it back
    assert set(got.arrays) == set(ref.arrays)
    np.testing.assert_array_equal(got["average"], ref["average"])
    assert_bundles_agree(TMeta("m", tmp_path).load(), ref)


def test_jax_resumes_from_the_port_bundle(both, tmp_path):
    params, jd, td, _, st = both
    for f in td.glob("m.meta.*"):
        (tmp_path / f.name).write_bytes(f.read_bytes())
    s = jspr.process_micrograph({"name": "m"}, params, tmp_path)
    assert s["particles"] == st["particles"] and s["df1"] == st["df1"]
    s = jspr.process_micrograph({"name": "m"}, {**params, "ctf_force": True,
                                                "detect_force": True}, tmp_path)
    assert_bundles_agree(TMeta("m", td).load(), JMeta("m", tmp_path).load())


def _gain_files(tmp_path):
    rng = np.random.RandomState(3)
    gain = rng.uniform(0.9, 1.1, (256, 256)).astype(np.float32)
    jmrc.write(gain, tmp_path / "gain.mrc")
    (tmp_path / "defects.txt").write_text("# x y w h\n10 20\n100 50 3 2\n")
    return str(tmp_path / "gain.mrc"), str(tmp_path / "defects.txt")


OPTION_CASES = {
    "skip_alignment": dict(movie_ali="skip"),
    "patches_unweighted": dict(movie_patches=2, movie_weights=False,
                               movie_search=20.0),
    "patches_weighted": dict(movie_patches=2, movie_search=20.0),
    "large_path": dict(movie_large_threshold_mpix=0.5, movie_align_bin=2,
                       scope_dose_rate=1.5, scope_init_dose=2.0),
    "middle_phase_only_tol": dict(movie_ref="middle", movie_phase_only=True,
                                  movie_tol=0.05, movie_weights=False),
    "frames_and_contrast": dict(movie_first=1, movie_last=11, movie_group=2,
                                data_invert=True, detect_invert=False,
                                data_remove_xrays=False),
    "gain": dict(gain=True, data_flipy=True, gain_rotation=1, gain_fliph=True,
                 gain_flipv=True, movie_force_integer=True),
    "magcorr": dict(movie_magcorr=True, scope_mag_major=1.02,
                    scope_mag_minor=0.99, scope_distort_ang=25.0),
    "ctf_extras": dict(ctf_use_lcl=True, ctf_determine_thickness=True,
                       ctf_known_ast=800.0, ctf_known_ast_angle=30.0),
    "ctf_phase": dict(ctf_use_phs=True, ctf_phase_steps=5, ctf_use_ast=False),
    "gold_and_no_picks": dict(detect_gold_erase=True, detect_gold_rad=6.0,
                              detect_thresh=2.0, detect_contamination=False),
    "detect_none": dict(detect_method="none"),
}


@pytest.mark.parametrize("case", sorted(OPTION_CASES))
def test_process_micrograph_options(movie, tmp_path, case):
    kw = dict(OPTION_CASES[case])
    if kw.pop("gain", False):
        kw["gain_reference"], kw["gain_defects_file"] = _gain_files(tmp_path)
    params = params_with(**kw)
    jd, td = tmp_path / "jax", tmp_path / "port"
    frames = np.abs(movie * 4).round() if case == "gain" else movie
    sj = jspr.process_micrograph({"name": "m", "frames": frames.copy()},
                                 params, jd)
    st = tspr.process_micrograph({"name": "m", "frames": frames.copy()},
                                 params, td, device="cpu")
    assert st["particles"] == sj["particles"]
    assert_bundles_agree(TMeta("m", td).load(), JMeta("m", jd).load())


def test_extract_stack_options(both, tmp_path):
    params, jd, td, _, _ = both
    for d in (jd, td):
        meta = JMeta("m", d).load()
        meta["ctf_plane"] = np.array([20000.0, 1.5, -2.0])
        meta.directory = tmp_path / d.name
        meta.save()
    p = {**params, "extract_bin": 2, "extract_box": 24, "extract_inv": False,
         "extract_subpixel": False, "extract_fmt": "mrcs",
         "extract_float16": True}
    stack_j, table_j = jspr.extract_stack(["m", "absent"], p, tmp_path / "jax")
    stack_t, table_t = tspr.extract_stack(["m", "absent"], p,
                                          tmp_path / "port", device="cpu")
    assert stack_t.dtype == np.float16 and stack_t.shape == stack_j.shape
    close(stack_t.astype(np.float32), stack_j.astype(np.float32), rtol=1e-2,
          atol_rel=2e-3)
    assert (tmp_path / "port" / "stack.mrcs").exists()
    np.testing.assert_allclose(table_t["defocus_1"], table_j["defocus_1"],
                               atol=50.0)
    np.testing.assert_array_equal(table_t["pixel_size"], table_j["pixel_size"])
    assert tspr.extract_stack(["absent"], p, tmp_path / "port",
                              device="cpu") == (None, None)


def test_load_movie_reads_every_format(tmp_path):
    import bz2
    import gzip

    from pyp_tpu.io import dm, eer, tiff

    rng = np.random.RandomState(0)
    counts = rng.poisson(2.0, (3, 24, 32)).astype(np.uint8)
    jmrc.write(counts.astype(np.int8), tmp_path / "m.mrc")
    jmrc.write(counts[0].astype(np.float32), tmp_path / "one.mrc")
    tiff.write(counts, tmp_path / "m.tif")
    dm.write_dm4(counts.astype(np.int16), tmp_path / "m.dm4")
    (tmp_path / "m.mrc.bz2").write_bytes(bz2.compress((tmp_path / "m.mrc").read_bytes()))
    (tmp_path / "m.tif.gz").write_bytes(gzip.compress((tmp_path / "m.tif").read_bytes()))
    events = (rng.rand(4, 64, 64) < 0.02).astype(np.uint16)
    eer.write(tmp_path / "m.eer", events)
    for name in ("m.mrc", "one.mrc", "m.tif", "m.dm4", "m.mrc.bz2",
                 "m.tif.gz", "m.eer"):
        p = {"movie_eer_frames": 2}
        ref = jspr.load_movie(tmp_path / name, p)
        out = tspr.load_movie(tmp_path / name, p)
        assert out.dtype == np.float32 and out.ndim == 3
        np.testing.assert_array_equal(out, ref)
    raw = tspr.load_movie(tmp_path / "m.mrc", dtype=None)
    assert raw.dtype == np.int8
    np.testing.assert_array_equal(tspr._upload(raw, torch.device("cpu")).numpy(),
                                  counts.astype(np.float32))


def test_apply_gain_matches_jax(tmp_path):
    rng = np.random.RandomState(1)
    frames = rng.poisson(3.0, (4, 256, 256)).astype(np.float32)
    gain, defects = _gain_files(tmp_path)
    for kw in (dict(), dict(gain_reference=gain),
               dict(gain_reference=gain, gain_defects_file=defects,
                    data_flipy=True, gain_rotation=3, gain_fliph=True,
                    movie_force_integer=True)):
        ref = jspr.apply_gain(frames.copy(), kw)
        out = tspr.apply_gain(torch.from_numpy(frames.copy()), kw)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)


def test_spr_merge_and_estimate_gain(tmp_path):
    results = {"a": {"name": "a", "particles": 3, "ctf_fit_res": 4.0},
               "b": {"name": "b", "particles": 5, "ctf_fit_res": 6.0},
               "c": None}
    assert tspr.spr_merge(results, ["c"]) == jspr.spr_merge(results, ["c"])
    rng = np.random.RandomState(2)
    flat = rng.uniform(0.8, 1.2, (16, 20))
    paths = []
    for i in range(3):
        jmrc.write(rng.poisson(20 * flat, (5, 16, 20)).astype(np.int8),
                   tmp_path / f"g{i}.mrc")
        paths.append(str(tmp_path / f"g{i}.mrc"))
    ref = jspr.estimate_gain(paths, max_movies=2)
    out = tspr.estimate_gain(paths, max_movies=2, device="cpu")
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=1e-6)
    with pytest.raises(ValueError, match="no movies"):
        tspr.estimate_gain([], device="cpu")


def _run_cli(cli, argv, cwd, **kw):
    buf = io.StringIO()
    here = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv, **kw)
    finally:
        os.chdir(here)
    text = buf.getvalue()
    return rc, (json.loads(text[text.index("{"):]) if "{" in text else None)


FLAGS = ["-scope_pixel", "1.0", "-detect_rad", "16", "-extract_box", "32",
         "-ctf_tile", "128", "-no_plot_per_item"]


def test_cli_spr_extract_gain_match_jax(movie, tmp_path):
    movies = tmp_path / "movies"
    movies.mkdir()
    for i in range(2):
        jmrc.write(np.roll(movie, 17 * i, axis=2), movies / f"mov_{i}.mrc")
    jd, td = tmp_path / "jax", tmp_path / "port"
    jd.mkdir(), td.mkdir()
    argv = ["spr", "-data_path", str(movies / "mov_*.mrc")] + FLAGS
    rc_j, merge_j = _run_cli(jcli, argv, jd)
    rc_t, merge_t = _run_cli(tcli, argv, td, device="cpu")
    assert rc_j == rc_t == 0
    assert merge_t["micrographs"] == 2 and merge_t["missing"] == []
    assert merge_t["particles"] == merge_j["particles"]
    for name in ("mov_0", "mov_1"):
        assert_bundles_agree(TMeta(name, td).load(), JMeta(name, jd).load())
    # the second call resumes: no bundle is rewritten
    stamps = {p.name: p.stat().st_mtime_ns for p in td.glob("*.meta.npz")}
    rc, again = _run_cli(tcli, argv, td, device="cpu")
    assert rc == 0 and again == merge_t
    assert stamps == {p.name: p.stat().st_mtime_ns for p in td.glob("*.meta.npz")}
    # a subset and a suffix filter
    rc, sub = _run_cli(tcli, argv + ["-data_suffix", "mov_1"], td, device="cpu")
    assert rc == 0 and sub["micrographs"] == 1
    rc_j, out_j = _run_cli(jcli, ["extract"], jd)
    rc_t, out_t = _run_cli(tcli, ["extract"], td, device="cpu")
    assert rc_j == rc_t == 0 and out_t == out_j
    close(jmrc.read(td / "stack.mrc"), jmrc.read(jd / "stack.mrc"))
    rc_j, g_j = _run_cli(jcli, ["gain", "-data_path", str(movies / "*.mrc")], jd)
    rc_t, g_t = _run_cli(tcli, ["gain", "-data_path", str(movies / "*.mrc")],
                         td, device="cpu")
    assert rc_j == rc_t == 0 and g_t == g_j
    close(jmrc.read(td / "gain.mrc"), jmrc.read(jd / "gain.mrc"), rtol=1e-5)


def test_cli_refusals_and_empty_inputs(movie, tmp_path):
    jmrc.write(movie[:2], tmp_path / "mov.mrc")
    argv = ["spr", "-data_path", str(tmp_path / "mov.mrc")] + FLAGS
    # the SLURM parameters (refused until the SLURM slice) write the swarm
    # scripts, and no bundle is made here
    for extra, word in ((["-slurm_queue", "gpu"], "SLURM"),):
        work = tmp_path / word
        work.mkdir()
        rc, report = _run_cli(tcli, argv + extra, work, device="cpu")
        assert rc == 0 and report["n_items"] == 1
        assert (work / "swarm" / "sprswarm.sbatch").exists()
        assert not list(work.glob("*.meta.npz"))
    work = tmp_path / "empty"
    work.mkdir()
    assert _run_cli(tcli, ["spr", "-data_path", "none*.mrc"], work,
                    device="cpu")[0] == 1
    assert _run_cli(tcli, ["extract"], work, device="cpu")[0] == 1
    assert _run_cli(tcli, ["gain", "-data_path", "none*.mrc"], work,
                    device="cpu")[0] == 1


def test_filter_selection_limits_the_items(tmp_path):
    from pyp_tpu_torch.analysis.filters import load_selection

    for name in ("a", "b", "c"):
        (tmp_path / f"{name}.mrc").write_bytes(b"")
    (tmp_path / "ds_good.filter.json").write_text(json.dumps({"keep": ["a", "c"]}))
    here = os.getcwd()
    os.chdir(tmp_path)
    try:
        p = {"data_path": "*.mrc", "filter_sel": "good", "data_set": "ds"}
        assert [i["name"] for i in tcli._discover_items(p)] == ["a", "c"]
        assert tcli._discover_items(p) == jcli._discover_items(p)
        p = {"data_path": "*.mrc", "data_first_item": 1, "data_last_item": 3}
        assert tcli._discover_items(p) == jcli._discover_items(p)
        assert load_selection("good", ".", "ds") == {"a", "c"}
    finally:
        os.chdir(here)


def test_planted_movie_is_recovered(tmp_path):
    """tools/e2e_spr at a small size (2 movies of 8 x 1024², 4 particles
    each) through the spr and extract modes: drift, defocus, astigmatism
    angle and particle positions come back."""
    from pyp_tpu_torch.tools import e2e_spa, e2e_spr

    volume = e2e_spa.make_dataset(n_particles=1, device="cpu")["volume"]
    kw = dict(e2e_spr.MOVIES)
    kw.update(n_movies=2, n_frames=8, size=1024, dose=5.0)
    truth, nbytes = e2e_spr.write_movies(tmp_path / "movies", volume,
                                         device="cpu", **kw)
    assert nbytes > 2 * 8 * 1024 * 1024
    work = tmp_path / "project"
    work.mkdir()
    argv = e2e_spr.SPR_ARGS + ["-data_path", str(tmp_path / "movies" / "movie_*.mrc"),
                               "-movie_large_threshold_mpix", "1",
                               "-scope_dose_rate", "5.0"]
    rc, merge = _run_cli(tcli, argv, work, device="cpu")
    assert rc == 0 and merge["micrographs"] == 2
    for name, t in truth.items():
        meta = TMeta(name, work).load()
        assert e2e_spr.drift_rms_error(meta["drift"], t["trajectory"]) < 0.5
        c = meta["ctf"]
        assert abs((c[0] + c[1]) / (t["df1"] + t["df2"]) - 1) < 0.01
        assert e2e_spr.angle_error_deg(c[2], t["angast"]) < 10.0
        recall, precision = e2e_spr.pick_recall_precision(
            meta["box"][:, :2], t["centres"], e2e_spr.PARTICLE_RADIUS_A / 2)
        assert recall >= 0.75 and precision >= 0.75
    rc, out = _run_cli(tcli, ["extract"], work, device="cpu")
    assert rc == 0 and out["particles"] == merge["particles"]
