"""Parity of pyp_tpu_torch.pipeline.classify3d (K-class 3D classification)
and analysis.occupancies with the JAX package on the CPU, at box 24 /
2 Å per pixel with 32 particles of two states (a seeded volume, and the
same volume with a blob added) at consensus poses (the true ones).

Tolerances:
  * occupancies: every function exact (the same numpy code);
  * one classify3d_iteration with the FRM engine, the gather engine and
    the focused path: occupancies within 1e-3 (percent), assignments
    equal, per-class maps cc >= 0.999;
  * classify3d_loop (two iterations; resumed from a previous classes
    table; without poses, the jittered-model fallback) and the classify3d
    mode: assignments equal, maps cc >= 0.999, the same files; the
    occupancies within 1e-2 (percent), since a second iteration scores
    against maps that already differ in the last bits, and the log
    likelihood proxy scales score differences by the band's point count.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pyp_tpu.analysis import occupancies as jocc
from pyp_tpu.config.params import defaults
from pyp_tpu.core.filters import lowpass_filter_3d, soft_spherical_mask
from pyp_tpu.core.geometry import euler_to_matrix
from pyp_tpu.io import cistem
from pyp_tpu.ops import fourier_slice as fs
from pyp_tpu.ops import reconstruct as jrec
from pyp_tpu.pipeline import classify3d as jc3
from pyp_tpu_torch.analysis import occupancies as tocc
from pyp_tpu_torch.pipeline import classify3d as tc3

BOX, PIXEL, PER_STATE = 24, 2.0, 16


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _volume(seed):
    rng = np.random.RandomState(seed)
    vol = rng.randn(BOX, BOX, BOX).astype(np.float32)
    vol *= np.asarray(soft_spherical_mask(BOX, BOX * 0.35, 3.0))
    return np.array(lowpass_filter_3d(jnp.asarray(vol), PIXEL, 3.0 * PIXEL)) * 10


def _particles(vol, seed):
    rng = np.random.RandomState(seed)
    n = PER_STATE
    phi = rng.uniform(0, 360, n).astype(np.float32)
    theta = np.degrees(np.arccos(rng.uniform(-1, 1, n))).astype(np.float32)
    psi = rng.uniform(0, 360, n).astype(np.float32)
    shifts = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    df = rng.uniform(12000, 25000, n).astype(np.float32)
    cp = np.stack([df + 500, df - 500, np.full(n, 30.0), np.zeros(n)],
                  1).astype(np.float32)
    R = euler_to_matrix(jnp.asarray(phi), jnp.asarray(theta), jnp.asarray(psi))
    F = fs.project(fs.volume_to_fourier(jnp.asarray(vol)), R, BOX)
    F = jrec._shift_correct(F * jrec._ctf_grids(BOX, PIXEL, jnp.asarray(cp),
                                                300.0, 2.7, 0.07),
                            jnp.asarray(shifts), BOX)
    imgs = np.array(fs.fourier_to_image(F, BOX))
    imgs += 0.1 * np.abs(imgs).max() * rng.randn(*imgs.shape).astype(np.float32)
    return imgs, cp, np.stack([phi, theta, psi], 1), shifts


@pytest.fixture(scope="module")
def states():
    """Two states: A, and A plus a soft blob of radius 3 px at (+5, 0, 0)
    px (x, y, z); 16 particles each at consensus poses."""
    vol_a = _volume(0)
    ax = np.arange(BOX) - BOX // 2
    r = np.sqrt((ax[None, None, :] - 5) ** 2 + ax[None, :, None] ** 2
                + ax[:, None, None] ** 2)
    vol_b = vol_a + np.percentile(vol_a, 99) * np.clip(4.0 - r, 0, 1)
    ia, ca, aa, sa = _particles(vol_a, 1)
    ib, cb, ab, sb = _particles(vol_b.astype(np.float32), 2)
    stack = np.concatenate([ia, ib]).astype(np.float32)
    ctf = np.concatenate([ca, cb])
    ang = np.concatenate([aa, ab])
    sh = np.concatenate([sa, sb])
    B = len(stack)
    table = cistem.Table.zeros(B)
    table["position_in_stack"] = np.arange(1, B + 1)
    table["pixel_size"] = np.full(B, PIXEL)
    table["defocus_1"], table["defocus_2"] = ctf[:, 0], ctf[:, 1]
    table["defocus_angle"] = ctf[:, 2]
    table["occupancy"] = np.full(B, 100.0)
    table["assigned_subset"] = np.arange(B) % 2 + 1
    table["phi"], table["theta"], table["psi"] = ang.T
    table["y_shift"] = -sh[:, 0] * PIXEL
    table["x_shift"] = -sh[:, 1] * PIXEL
    return stack, table, vol_a, vol_b.astype(np.float32)


def _params(**kw):
    p = defaults()
    p.update({"scope_pixel": PIXEL, "class_num": 2, "refine_maxiter": 3,
              "refine_iter": 2, "refine_rhref": "6", "class_rhcls": 6.0,
              "refine_rlref": 40.0, "refine_dang": "20",
              "refine_local_iters": 6, "particle_sym": "C1",
              "class3d_iters": 1, "plot_per_item": False})
    p.update(kw)
    return p


def _copy(table):
    return cistem.Table(list(table.column_ids),
                        {k: np.array(v) for k, v in table.data.items()})


def cc(a, b):
    return float(np.corrcoef(np.ravel(a), np.ravel(b))[0, 1])


def test_occupancies_functions_are_exact():
    rng = np.random.RandomState(0)
    logp = rng.randn(9, 3) * 20
    prior = np.array([20.0, 30.0, 50.0])
    for args in ((logp,), (logp, prior, 2.0)):
        np.testing.assert_array_equal(tocc.occupancies_from_logp(*args),
                                      jocc.occupancies_from_logp(*args))
    ang = np.array([-60.0, -30, 0, 30, 60])
    np.testing.assert_array_equal(tocc.tilt_angle_weights(ang),
                                  jocc.tilt_angle_weights(ang))
    np.testing.assert_array_equal(tocc.tilt_angle_weights(0 * ang),
                                  jocc.tilt_angle_weights(0 * ang))
    s = rng.rand(5, 9, 3)
    valid = rng.rand(5, 9) > 0.3
    for v in (None, valid):
        np.testing.assert_array_equal(tocc.score_average_weights(s, v),
                                      jocc.score_average_weights(s, v))
    for sw in (False, True):
        np.testing.assert_array_equal(
            tocc.aggregate_tilt_logp(s, valid, ang, sw),
            jocc.aggregate_tilt_logp(s, valid, ang, sw))
    occ = tocc.classification_initialization(9, 3, seed=4)
    np.testing.assert_array_equal(occ, jocc.classification_initialization(9, 3, seed=4))
    np.testing.assert_array_equal(tocc.update_average_occupancies(occ),
                                  jocc.update_average_occupancies(occ))
    np.testing.assert_array_equal(tocc.hard_assignments(occ),
                                  jocc.hard_assignments(occ))


@pytest.mark.parametrize("path", ["frm", "gather", "focused"])
def test_classify3d_iteration_matches_jax(states, path):
    stack, table, vol_a, vol_b = states
    kw = {"refine_engine": "gather"} if path == "gather" else {}
    if path == "focused":
        kw["class_focusmask"] = "10,0,0,8"
    params = _params(**kw)
    refs = [vol_a, vol_b]
    occ = tocc.classification_initialization(len(stack), 2, seed=0)
    jt, jrefs, jo, jres = jc3.classify3d_iteration(
        stack, _copy(table), refs, occ, params, 2)
    tt, trefs, to, tres = tc3.classify3d_iteration(
        stack, _copy(table), refs, occ, params, 2, device="cpu")
    np.testing.assert_allclose(to, jo, atol=1e-3)
    np.testing.assert_array_equal(tt["best_2d_class"], jt["best_2d_class"])
    for k in range(2):
        assert cc(trefs[k], jrefs[k]) >= 0.999
    # the states separate from their own references
    labels = np.repeat([1, 2], PER_STATE)
    assert (np.asarray(tt["best_2d_class"]) == labels).mean() >= 0.8


def test_classify3d_loop_resume_and_fallback_match_jax(states, tmp_path):
    stack, table, vol_a, vol_b = states
    consensus = 0.5 * (vol_a + vol_b)
    params = _params(class3d_iters=2, plot_per_item=True)
    out = {}
    for name, fn in (("jax", jc3.classify3d_loop),
                     ("port", lambda *a: tc3.classify3d_loop(*a, device="cpu"))):
        d = tmp_path / name
        first = fn(stack, _copy(table), consensus, params, d, "cls")
        # resume from the classes table the first run wrote
        again = fn(stack, _copy(table), consensus, params, d, "cls")
        # no poses: jittered copies of the initial model seed the classes
        bare = _copy(table)
        for k in ("phi", "theta", "psi"):
            bare[k] = np.zeros(len(stack))
        fallback = fn(stack, bare, consensus,
                      _params(class3d_iters=1), tmp_path / f"{name}_bare", "cls")
        out[name] = (first, again, fallback)
        assert sorted(p.name for p in (d / "maps").iterdir()) == [
            "cls_classes_02.cistem", "cls_classes_03.cistem",
            "cls_history.json", "cls_occupancy.png",
            "cls_r01_02.mrc", "cls_r01_03.mrc", "cls_r02_02.mrc",
            "cls_r02_03.mrc"]
    for j, t in zip(out["jax"], out["port"]):
        np.testing.assert_array_equal(t[0]["best_2d_class"],
                                      j[0]["best_2d_class"])
        np.testing.assert_allclose(t[2], j[2], atol=1e-2)
        for k in range(2):
            assert cc(t[1][k], j[1][k]) >= 0.999


def test_plot_occupancy_history_writes_png(tmp_path):
    from pyp_tpu_torch.analysis.plots import plot_occupancy_history

    hist = [{"iteration": i, "occupancy": [40.0 + i, 60.0 - i]}
            for i in (2, 3, 4)]
    plot_occupancy_history(hist, tmp_path / "occ.png")
    assert (tmp_path / "occ.png").read_bytes()[:4] == b"\x89PNG"
    plot_occupancy_history([{"iteration": 2}], tmp_path / "none.png")
    assert not (tmp_path / "none.png").exists()


def test_classify3d_mode_matches_jax(states, tmp_path, monkeypatch):
    from pyp_tpu import cli as jcli
    from pyp_tpu.io import mrc
    from pyp_tpu_torch import cli as tcli

    stack, table, vol_a, vol_b = states
    argv = ["classify3d", "-class_num", "2", "-class3d_iters", "1",
            "-refine_rhref", "6", "-class_rhcls", "6", "-refine_rlref", "40",
            "-refine_dang", "20", "-scope_pixel", str(PIXEL),
            "-no_plot_per_item"]
    out = {}
    for name, main in (("jax", jcli.main),
                       ("port", lambda a: tcli.main(a, device="cpu"))):
        d = tmp_path / name
        d.mkdir()
        mrc.write(stack, d / "stack.mrc", pixel_size=PIXEL)
        cistem.write_parameters(_copy(table), d / "stack.cistem")
        mrc.write(0.5 * (vol_a + vol_b), d / "initial_model.mrc",
                  pixel_size=PIXEL)
        monkeypatch.chdir(d)
        assert main(argv) == 0
        out[name] = (cistem.read_parameters(d / "stack.cistem"),
                     [mrc.read(d / "maps" / f"dataset_r0{k}_02.mrc")
                      for k in (1, 2)])
    np.testing.assert_array_equal(out["port"][0]["best_2d_class"],
                                  out["jax"][0]["best_2d_class"])
    for k in range(2):
        assert cc(out["port"][1][k], out["jax"][1][k]) >= 0.999
