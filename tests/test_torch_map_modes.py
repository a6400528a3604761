"""The SPA back half of the port end to end against the JAX package on the
CPU: the `postprocess`, `fsc` and `mask` CLI modes, the refine loop with
every reconstruction option on (final B-factor sharpening, score shaping,
likelihood blurring, reference-based Ewald insertion, model fitting,
matching projections), the final-iteration sharpening of a loop that skips
refinement, and a postprocess of each package's half maps by the other.

The loop runs 48 particles at box 32, 2 Å per pixel (tests/test_refine3d.py),
refine_maxiter 2 with the FRM engine and the gold standard; the JAX side
takes its single-device path (PYP_TPU_DISABLE_SPMD=1). Phases of the
masked FSC are JAX's (`same_phases`). Tolerances: final maps Pearson cc
>= 0.99; >= 90% of final poses within 1°; FSC(0.143) resolutions within
one Fourier shell; model cc within 0.02 and the same shift; the same
files; postprocess maps atol 1e-3 * max|map|, resolutions within 1e-3 Å;
FSC tables atol 1e-4; masks atol 1e-5."""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_refine3d import N, PIXEL, make_particles, make_volume
from test_torch_postprocess import jax_phases

from pyp_tpu import cli as jcli
from pyp_tpu.config import schema
from pyp_tpu.core.filters import lowpass_filter_3d
from pyp_tpu.core.geometry import euler_to_matrix
from pyp_tpu.io import cistem, mrc
from pyp_tpu.pipeline import refine as jref
from pyp_tpu.postprocess import core as jpost
from pyp_tpu_torch import cli as tcli
from pyp_tpu_torch.ops import fourier_slice as tfs
from pyp_tpu_torch.pipeline import refine as tref
from pyp_tpu_torch.postprocess import core as tpost
from pyp_tpu_torch.tools import e2e_spa

N_PART = 48


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def same_phases(monkeypatch):
    monkeypatch.setattr(tpost, "_random_phases", jax_phases)


def close(port, ref, atol_rel=1e-3):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    np.testing.assert_allclose(port, ref, rtol=0,
                               atol=atol_rel * float(np.abs(ref).max()))


@pytest.fixture(scope="module")
def halves():
    rng = np.random.RandomState(21)
    sig = make_volume(seed=6)
    amp = 0.4 * sig.std()
    return (sig + amp * rng.randn(N, N, N).astype(np.float32),
            sig + amp * rng.randn(N, N, N).astype(np.float32))


def _in_dirs(tmp_path, monkeypatch, fn):
    """fn(package_cli) run once per package in its own directory; returns
    {name: (exit code, directory)}."""
    out = {}
    for name, cli in (("jax", jcli), ("port", tcli)):
        work = tmp_path / name
        work.mkdir()
        monkeypatch.chdir(work)
        out[name] = (fn(cli), work)
    return out


def _main(cli, argv):
    return (cli.main(argv, device="cpu") if cli is tcli else cli.main(argv))


def test_mode_fsc(tmp_path, monkeypatch, capsys, halves):
    """test_cli_modes.py::test_mode_fsc on the port, against the JAX mode:
    the same <out>.txt (header and values) and the same JSON."""
    h1, h2 = halves

    def run(cli):
        mrc.write(h1, "h1.mrc", pixel_size=1.5)
        mrc.write(h2, "h2.mrc", pixel_size=1.5)
        rc = _main(cli, ["fsc", "h1.mrc", "h2.mrc"])
        js = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert _main(cli, ["fsc", "h1.mrc", "h1.mrc", "-fsc_out", "self"]) == 0
        assert _main(cli, ["fsc", "h1.mrc"]) == 1
        capsys.readouterr()
        return rc, js

    out = _in_dirs(tmp_path, monkeypatch, run)
    (rc_j, js_j), wj = out["jax"]
    (rc_t, js_t), wt = out["port"]
    assert rc_j == rc_t == 0
    assert js_t["pairs"][0]["res_0.143_A"] >= 3.0
    for a, b in zip(js_t["pairs"], js_j["pairs"]):
        assert a["pair"] == b["pair"]
        for k in ("res_0.5_A", "res_0.143_A"):
            assert a[k] == pytest.approx(b[k], abs=1e-3)
    for name in ("fsc.txt", "self.txt"):
        assert ((wt / name).read_text().splitlines()[0]
                == (wj / name).read_text().splitlines()[0])
        np.testing.assert_allclose(np.loadtxt(wt / name), np.loadtxt(wj / name),
                                   atol=1e-4)
    np.testing.assert_allclose(np.loadtxt(wt / "self.txt")[:, 1], 1.0, atol=1e-3)


def test_mode_fsc_masked(tmp_path, monkeypatch, capsys, halves, same_phases):
    h1, h2 = halves
    mask = np.asarray(jpost.auto_mask(h1 + h2, pixel_size=PIXEL))

    def run(cli):
        mrc.write(h1, "a_half1.mrc", pixel_size=PIXEL)
        mrc.write(h2, "a_half2.mrc", pixel_size=PIXEL)
        mrc.write(mask, "mask.mrc", pixel_size=PIXEL)
        rc = _main(cli, ["fsc", "a_half1.mrc", "a_half2.mrc", "-fsc_mask",
                         "mask.mrc", "-fsc_out", "masked"])
        return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    out = _in_dirs(tmp_path, monkeypatch, run)
    (rc_j, js_j), wj = out["jax"]
    (rc_t, js_t), wt = out["port"]
    assert rc_j == rc_t == 0 and js_t["masked"] and js_j["masked"]
    np.testing.assert_allclose(np.loadtxt(wt / "masked.txt"),
                               np.loadtxt(wj / "masked.txt"), atol=1e-4)


@pytest.mark.parametrize("args", [
    ["-mask_method", "sphere", "-mask_radius", "8"],
    ["-mask_method", "auto", "-mask_lowpass", "8"],
    ["-mask_method", "auto", "-mask_invert", "-mask_normalized",
     "-mask_outside_weight", "0.2"],
], ids=["sphere", "auto", "invert_normalized_outside"])
def test_mode_mask(tmp_path, monkeypatch, capsys, args):
    """test_cli_modes.py::test_mode_mask_sphere_and_auto on the port, and
    the same <dataset>_mask.mrc as the JAX mode."""
    rng = np.random.RandomState(0)
    vol = np.zeros((32, 32, 32), np.float32)
    vol[12:20, 12:20, 12:20] = 5.0
    vol += rng.randn(32, 32, 32).astype(np.float32) * 0.1

    def run(cli):
        mrc.write(vol, "model.mrc")
        rc = _main(cli, ["mask", "-model_path", "model.mrc", "-data_set", "d",
                         *args])
        return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    out = _in_dirs(tmp_path, monkeypatch, run)
    (rc_j, js_j), wj = out["jax"]
    (rc_t, js_t), wt = out["port"]
    assert rc_j == rc_t == 0 and js_t == js_j
    m = mrc.read(wt / "d_mask.mrc")
    np.testing.assert_allclose(m, mrc.read(wj / "d_mask.mrc"), atol=1e-5)
    if "-mask_invert" not in args:
        assert m[16, 16, 16] > 0.5 and m[2, 2, 2] < 0.2


def test_mode_mask_from_maps_half_maps(tmp_path, monkeypatch, capsys, halves):
    """No -model_path: the mask of the newest maps/ half-map pair. (The
    JAX mode reads Path("") — the directory — there, so the port is held
    to the JAX package's auto_mask of the summed halves instead.)"""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "maps").mkdir()
    mrc.write(halves[0], "maps/ds_r01_02_half1.mrc", pixel_size=PIXEL)
    mrc.write(halves[1], "maps/ds_r01_02_half2.mrc", pixel_size=PIXEL)
    assert tcli.main(["mask", "-data_set", "ds"], device="cpu") == 0
    capsys.readouterr()
    np.testing.assert_allclose(
        mrc.read(tmp_path / "ds_mask.mrc"),
        np.asarray(jpost.auto_mask(halves[0] + halves[1], pixel_size=PIXEL)),
        atol=1e-5)


def test_mode_mask_refuses_a_missing_model_path(tmp_path, monkeypatch, halves):
    """A -model_path that names no file is an error, even where maps/
    holds a half-map pair that could be masked instead."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "maps").mkdir()
    mrc.write(halves[0], "maps/ds_r01_02_half1.mrc", pixel_size=PIXEL)
    mrc.write(halves[1], "maps/ds_r01_02_half2.mrc", pixel_size=PIXEL)
    assert tcli.main(["mask", "-model_path", "missing.mrc", "-data_set", "ds"],
                     device="cpu") == 1
    assert not (tmp_path / "ds_mask.mrc").exists()


def test_mode_postprocess(tmp_path, monkeypatch, capsys, halves, same_phases):
    """cli.main(["postprocess", ...]) in each package: the same JSON
    summary and files."""
    def run(cli):
        Path("maps").mkdir()
        mrc.write(halves[0], "maps/ds_r01_03_half1.mrc", pixel_size=PIXEL)
        mrc.write(halves[1], "maps/ds_r01_03_half2.mrc", pixel_size=PIXEL)
        rc = _main(cli, ["postprocess", "-data_set", "ds", "-no_plot_per_item",
                         "-sharpen_ampl_corr", "-sharpen_locres",
                         "-sharpen_locres_sampling", "20"])
        return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    out = _in_dirs(tmp_path, monkeypatch, run)
    (rc_j, js_j), wj = out["jax"]
    (rc_t, js_t), wt = out["port"]
    assert rc_j == rc_t == 0 and sorted(js_t) == sorted(js_j)
    assert js_t["resolution_A"] == pytest.approx(js_j["resolution_A"], abs=1e-3)
    assert js_t["locres_median_A"] == pytest.approx(js_j["locres_median_A"], abs=1e-3)
    names = sorted(p.name for p in (wj / "maps").iterdir())
    assert names == sorted(p.name for p in (wt / "maps").iterdir())
    for name in names:
        if name.endswith(".mrc"):
            close(mrc.read(wt / "maps" / name), mrc.read(wj / "maps" / name))


# --- the refine loop with every reconstruction option ---------------------

@pytest.fixture(scope="module")
def problem():
    vol = make_volume(seed=2)
    imgs, cp, _ = make_particles(vol, n_particles=N_PART, noise=0.1, seed=5)
    cp = np.asarray(cp)
    table = cistem.Table.zeros(N_PART)
    table["position_in_stack"] = np.arange(1, N_PART + 1)
    table["pixel_size"] = np.full(N_PART, PIXEL)
    table["defocus_1"] = cp[:, 0]
    table["defocus_2"] = cp[:, 1]
    table["defocus_angle"] = cp[:, 2]
    table["occupancy"] = np.full(N_PART, 100.0)
    start = np.array(lowpass_filter_3d(jnp.asarray(vol), PIXEL, 12.0))
    params = schema.defaults()
    params.update({
        "scope_pixel": PIXEL, "refine_engine": "frm", "refine_maxiter": 2,
        "refine_rhref": "8:6", "refine_dang": "12", "refine_searchx": 3.0,
        "refine_rlref": 100.0, "refine_goldstandard": True,
        "refine_frm_cone": 15.0,
    })
    return vol, np.array(imgs), table, start, params


@pytest.fixture(scope="module")
def option_runs(problem, tmp_path_factory):
    """The JAX loop and the port's with every option on. The port inserts
    the IEWALD-2 reference unscaled here, as the JAX loop does
    (ref_amplitude patched to 1); its fitted insertion is held against the
    truth by the test_iewald2_loop_* tests."""
    vol, stack, table, start, params = problem
    pdb = e2e_spa.write_pseudo_atom_pdb(
        vol, PIXEL, N ** 3 // 32, tmp_path_factory.mktemp("pdb") / "m.pdb")
    params = {**params, "reconstruct_fbfact": True,
              "reconstruct_score_fraction": 0.9, "reconstruct_lblur": True,
              "reconstruct_lblur_nrot": 5, "reconstruct_lblur_range": 6.0,
              "reconstruct_iewald": 2, "refine_fmatch": True,
              "model_fit": pdb, "plot_per_item": False,
              # normalized particles make the JAX loop's IEWALD-2 insertion
              # diverge (test_iewald2_loop_with_normalized_particles)
              "reconstruct_norm": False}
    mp = pytest.MonkeyPatch()
    mp.setenv("PYP_TPU_DISABLE_SPMD", "1")
    try:
        jdir = tmp_path_factory.mktemp("jax")
        jout = jref.refine_loop(stack, table.copy(), start, dict(params),
                                work_dir=jdir, dataset="ds")
    finally:
        mp.undo()
    tdir = tmp_path_factory.mktemp("torch")
    mp.setattr(tfs, "ref_amplitude", lambda pred, F: torch.ones(F.shape[0]))
    try:
        tout = tref.refine_loop(stack, table.copy(), start, dict(params),
                                work_dir=tdir, dataset="ds", device="cpu")
    finally:
        mp.undo()
    return jdir, jout, tdir, tout


def _rot(table):
    return np.asarray(euler_to_matrix(*(jnp.asarray(np.asarray(table[k]))
                                        for k in ("phi", "theta", "psi"))))


def test_loop_with_every_option(option_runs):
    jdir, (jt, jmap, jhist), tdir, (tt, tmap, thist) = option_runs
    names = sorted(p.name for p in (jdir / "maps").iterdir())
    assert names == sorted(p.name for p in (tdir / "maps").iterdir())
    for f in ("ds_r01_03_sharp.mrc", "ds_match.mrc", "ds_model_fit.txt"):
        assert f in names
    assert np.corrcoef(np.asarray(jmap).ravel(), tmap.numpy().ravel())[0, 1] >= 0.99
    tr = np.einsum("bij,bij->b", _rot(jt), _rot(tt))
    diff = np.degrees(np.arccos(np.clip((tr - 1) / 2, -1, 1)))
    assert np.mean(diff < 1.0) >= 0.9, diff
    assert [h["iteration"] for h in thist] == [h["iteration"] for h in jhist] == [2, 3]
    for jh, th in zip(jhist, thist):
        assert set(jh) == set(th) and "model_cc" in th
        assert abs(1 / jh["resolution"] - 1 / th["resolution"]) <= 1.0 / (N * PIXEL)
        assert th["model_cc"] == pytest.approx(jh["model_cc"], abs=0.02)


def test_loop_option_files(option_runs):
    jdir, _, tdir, _ = option_runs
    a, b = (np.loadtxt(d / "maps" / "ds_model_fit.txt") for d in (jdir, tdir))
    assert a.shape == b.shape == (2, 5)
    np.testing.assert_array_equal(b[:, [0, 2, 3, 4]], a[:, [0, 2, 3, 4]])
    sj, st = (mrc.read(d / "maps" / "ds_r01_03_sharp.mrc") for d in (jdir, tdir))
    assert np.isfinite(st).all() and np.corrcoef(sj.ravel(), st.ravel())[0, 1] >= 0.98
    mj, mt = (mrc.read(d / "maps" / "ds_match.mrc") for d in (jdir, tdir))
    assert mt.shape == mj.shape == (N_PART, N, N)
    cc = [np.corrcoef(x.ravel(), y.ravel())[0, 1] for x, y in zip(mj, mt)]
    assert np.mean(np.asarray(cc) >= 0.95) >= 0.9, cc


@pytest.mark.parametrize("direction", ["port_reads_jax", "jax_reads_port"])
def test_postprocess_of_the_other_packages_half_maps(option_runs, tmp_path,
                                                     same_phases, direction):
    """Each package's postprocess on the other's final half maps gives
    what it gives on its own half maps, within one Fourier shell, and
    the same files."""
    jdir, _, tdir, _ = option_runs
    src = jdir if direction == "port_reads_jax" else tdir
    work = tmp_path / "w"
    (work / "maps").mkdir(parents=True)
    for h in ("half1", "half2"):
        (work / "maps" / f"ds_r01_03_{h}.mrc").write_bytes(
            (src / "maps" / f"ds_r01_03_{h}.mrc").read_bytes())
    params = {"plot_per_item": False}
    if direction == "port_reads_jax":
        out = tpost.postprocess_latest("ds", dict(params), work, device="cpu")
        ref = jpost.postprocess_latest("ds", dict(params), jdir)
    else:
        out = jpost.postprocess_latest("ds", dict(params), work)
        ref = tpost.postprocess_latest("ds", dict(params), tdir, device="cpu")
    assert abs(1 / out["resolution_A"] - 1 / ref["resolution_A"]) <= 1.0 / (N * PIXEL)
    assert out["bfactor"] < 0 and np.isfinite(mrc.read(out["map"])).all()
    assert sorted(p.name for p in (work / "maps").iterdir()) == sorted(
        ["ds_r01_03_half1.mrc", "ds_r01_03_half2.mrc", "ds_sharpened.mrc",
         "ds_fsc_masked.txt"])


def test_final_iteration_writes_sharpened_map(tmp_path):
    """test_framework.py's oracle on the port: with reconstruct_fbfact the
    final iteration of a loop that skips refinement writes one finite
    <ds>_rXX_II_sharp.mrc next to the unsharpened map."""
    vol = make_volume(seed=1)
    stack, ctf_params, truth = make_particles(vol, n_particles=16, seed=2)
    tt = cistem.Table.zeros(16)
    tt["pixel_size"] = np.full(16, PIXEL)
    for k in ("phi", "theta", "psi"):
        tt[k] = truth[k]
    cp = np.asarray(ctf_params)
    tt["defocus_1"], tt["defocus_2"], tt["defocus_angle"] = cp[:, 0], cp[:, 1], cp[:, 2]
    tt["occupancy"] = np.full(16, 100.0)
    params = schema.defaults()
    params.update({"scope_pixel": PIXEL, "refine_rhref": "8",
                   "refine_skip": True, "reconstruct_crop": False,
                   "refine_maxiter": 1, "reconstruct_fbfact": True})
    tref.refine_loop(np.asarray(stack), tt, np.asarray(vol), params,
                     work_dir=tmp_path, dataset="fb", device="cpu")
    sharp = list((tmp_path / "maps").glob("*_sharp.mrc"))
    assert [p.name for p in sharp] == ["fb_r01_02_sharp.mrc"]
    v = mrc.read(sharp[0])
    assert np.isfinite(v).all() and v.std() > 0


def _iewald2_loop_ccs(problem, tmp_path, monkeypatch, norm):
    """Pearson cc against the truth of the final map of each loop: JAX and
    the port at IEWALD 0 and 2, and the port at IEWALD 2 with the
    reference inserted unscaled as the JAX loop inserts it (ref_amplitude
    patched to 1)."""
    vol, stack, table, start, params = problem
    params = {**params, "plot_per_item": False, "reconstruct_norm": norm}
    monkeypatch.setenv("PYP_TPU_DISABLE_SPMD", "1")

    def run(pkg, iew, tag):
        p = {**params, "reconstruct_iewald": iew}
        if pkg is jref:
            final = jref.refine_loop(stack, table.copy(), start, p,
                                     work_dir=tmp_path / tag, dataset="ds")[1]
        else:
            final = tref.refine_loop(stack, table.copy(), start, p,
                                     work_dir=tmp_path / tag, dataset="ds",
                                     device="cpu")[1].numpy()
        return np.corrcoef(np.asarray(final).ravel(), vol.ravel())[0, 1]

    cc = {"j0": run(jref, 0, "j0"), "j2": run(jref, 2, "j2"),
          "t0": run(tref, 0, "t0"), "t2": run(tref, 2, "t2")}
    monkeypatch.setattr(tfs, "ref_amplitude",
                        lambda pred, F: torch.ones(F.shape[0]))
    cc["t2_unscaled"] = run(tref, 2, "t2u")
    return cc


def test_iewald2_loop_with_normalized_particles(problem, tmp_path,
                                               monkeypatch):
    """reconstruct_norm (the default) normalizes the particles, so they
    lose the starting map's scale. The JAX loop inserts the IEWALD-2
    reference unscaled there, and its final map falls far from the truth
    against its own loop without Ewald insertion; the port's loop with the
    reference unscaled gives the same cc, so the fall is the JAX loop's. The
    port fits the reference's amplitude per particle, and its loop ends as
    close to the truth as without Ewald insertion."""
    cc = _iewald2_loop_ccs(problem, tmp_path, monkeypatch, True)
    assert abs(cc["t0"] - cc["j0"]) < 0.02, cc
    assert abs(cc["t2_unscaled"] - cc["j2"]) < 0.02, cc
    assert cc["j2"] < cc["j0"] - 0.3, cc
    assert cc["t2"] >= cc["t0"] - 0.02, cc


def test_iewald2_loop_with_unnormalized_particles(problem, tmp_path,
                                                 monkeypatch):
    """Without normalization the starting map predicts the particles at
    their scale (fitted amplitude ~1), but the first reconstruction does
    not (~0.4 at this size): the JAX loop's unscaled IEWALD-2 insertion
    falls below its loop without Ewald insertion, the port's unscaled loop
    gives the same cc, and the port's fitted loop does not fall."""
    cc = _iewald2_loop_ccs(problem, tmp_path, monkeypatch, False)
    assert abs(cc["t2_unscaled"] - cc["j2"]) < 0.02, cc
    assert cc["j2"] < cc["j0"] - 0.1, cc
    assert cc["t2"] >= cc["t0"] - 0.02, cc
