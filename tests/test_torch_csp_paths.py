"""The CSP paths no CLI mode reaches, and the port's departures: parity of
`pipeline/csp.csp_classify` and `csp_polish_frames` with the JAX package
on the CPU; the sign of the bundle's `xf` (a planted series on a path of
each sign, `xf_shift_sign` +1 and -1, refines from the right shifts, and
the other sign scores lower); the stable seed of the random start eulers;
bundles crossing from one package to the other; and -csp_transreg 0,
which turns the trajectory penalty off in the port (the JAX package reads
it as 0.1).

Tolerances: classification scores and occupancies within 1e-3, class
maps within 3e-3 * max|reference| below 0.85 Nyquist, resolutions within
one shell; frame trajectories within 2e-3 px after 4 steps (normalized
gradient steps compound) and polished windows within 2e-3 * max|reference|.
"""

import os
import subprocess
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyp_tpu.io.metadata import ItemMetadata
from pyp_tpu.ops import csp as jcsp
from pyp_tpu.pipeline import csp as jpipe
from pyp_tpu_torch.ops import csp as tcsp
from pyp_tpu_torch.pipeline import csp as tpipe
from tests.test_csp import NBOX, PIXEL, T, make_reference, make_tilt_series
from tests.test_torch_csp_pipeline import close_maps, item_of, params, write_bundle

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def two_states():
    vol_a, vol_b = make_reference(seed=0), make_reference(seed=55)
    a = make_tilt_series(vol_a, seed=1, noise=0.08)
    b = make_tilt_series(vol_b, seed=2, noise=0.08)
    return vol_a, vol_b, a, b


def test_csp_classify_matches(two_states):
    vol_a, vol_b, (ta, ia, da), (tb, ib, db) = two_states
    p = params()
    items_j = [{"name": "a", "tilts": np.asarray(ia), "params": ta,
                "defocus": np.asarray(da)},
               {"name": "b", "tilts": np.asarray(ib), "params": tb,
                "defocus": np.asarray(db)}]
    outs_j, occ_j, res_j = jpipe.csp_classify(items_j, p, [vol_a, vol_b])
    items_t = [dict(it, params=tcsp.make_params(
        *(np.asarray(x) for x in it["params"]), device=CPU)) for it in items_j]
    outs_t, occ_t, res_t = tpipe.csp_classify(items_t, p, [vol_a, vol_b],
                                              device=CPU)
    for a, b in zip(occ_t, occ_j):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)
    for a, b in zip(outs_t, outs_j):
        close_maps(a.volume.numpy(), b.volume)
    assert np.all(np.abs(np.asarray(res_t) - np.asarray(res_j)) < 2.0 + 1e-6)
    # the two states separate
    assert (occ_t[0][:, 0] > occ_t[0][:, 1]).mean() > 0.8


@pytest.fixture(scope="module")
def movies():
    """Three tilt movies of 6 frames with a planted per-frame drift (the
    JAX test's construction, smaller: 4 particles, 96², box 24)."""
    from pyp_tpu.core.fft import shift_images
    from pyp_tpu.ops import fourier_slice as fs

    rng = np.random.RandomState(0)
    box, ny, nx, Tm, F, Pm = NBOX, 96, 96, 3, 6, 4
    vol = make_reference()
    angles = np.array([-30.0, 0.0, 30.0], np.float32)
    coords = np.stack([np.zeros(Pm), rng.uniform(-20, 20, Pm),
                       rng.uniform(-20, 20, Pm)], 1).astype(np.float32)
    eulers = rng.uniform(0, 360, (Pm, 3)).astype(np.float32)
    cp = jcsp.make_params(angles, np.zeros(Tm, np.float32),
                          np.zeros((Tm, 2), np.float32), eulers, coords)
    R_eff = np.asarray(jcsp.effective_rotations(cp))
    pred = np.asarray(jcsp.project_positions(cp))
    Fv = fs.volume_to_fourier(jnp.asarray(vol))
    drift = np.cumsum(rng.uniform(-0.7, 0.7, (Tm, F, 2)), axis=1).astype(
        np.float32)
    out = []
    for t in range(Tm):
        frames = rng.randn(F, ny, nx).astype(np.float32) * 0.3
        proj = np.asarray(fs.fourier_to_image(
            fs.project(Fv, jnp.asarray(R_eff[t]), box), box))
        for f in range(F):
            for p in range(Pm):
                cy = int(round(pred[t, p, 0])) + ny // 2
                cx = int(round(pred[t, p, 1])) + nx // 2
                sh = np.asarray(shift_images(jnp.asarray(proj[p])[None],
                                             jnp.asarray(drift[t, f])[None]))[0]
                frames[f, cy - box // 2:cy + box // 2,
                       cx - box // 2:cx + box // 2] += sh
        out.append(frames)
    return vol, cp, out


def test_csp_polish_frames_matches(movies):
    vol, cp, tilt_movies = movies
    p = {"scope_pixel": PIXEL, "scope_voltage": 300.0, "scope_cs": 2.7,
         "scope_wgh": 0.07, "csp_box": NBOX, "csp_rlref": 60.0,
         "csp_rhref": "8", "polish_iters": 4}
    defocus = np.full((3, 2), 15000.0, np.float32)
    doses = [np.arange(1, 7, dtype=np.float32)] * 3
    wj, tj = jpipe.csp_polish_frames(tilt_movies, cp, defocus, vol, p,
                                     doses=doses)
    wt, tt = tpipe.csp_polish_frames(
        tilt_movies, tcsp.make_params(*(np.asarray(x) for x in cp),
                                      device=CPU),
        defocus, vol, p, doses=doses, device=CPU)
    assert wt.shape == np.asarray(wj).shape == (3, 4, NBOX, NBOX)
    for a, b in zip(tt, tj):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=2e-3)
    np.testing.assert_allclose(wt, np.asarray(wj), rtol=0,
                               atol=2e-3 * np.abs(np.asarray(wj)).max())


@pytest.fixture(scope="module")
def planted():
    vol = make_reference()
    true, images, defocus = make_tilt_series(vol, seed=3, noise=0.05)
    return vol, dict(true=true, images=np.asarray(images),
                     defocus=np.asarray(defocus),
                     eulers=np.asarray(true.particle_eulers))


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_xf_sign_puts_the_projection_on_the_content(planted, sign, tmp_path):
    """`xf` of the port's tomo holds sign x the aligning shift, the content
    sitting at minus it: on either path the port reads the planted content
    offset back, and reading the other sign scores lower."""
    vol, d = planted
    shifts = np.asarray(d["true"].tilt_shifts)       # the content offset
    d = dict(d, xf=np.concatenate([-sign * shifts, np.full((T, 1), 2.0)],
                                  axis=1).astype(np.float32))
    write_bundle(d, "ts", tmp_path, sign=sign)
    meta = ItemMetadata("ts", tmp_path, mode="tomo").load()
    from pyp_tpu_torch.io.metadata import ItemMetadata as TMeta

    tmeta = TMeta("ts", tmp_path, mode="tomo").load()
    cp = tpipe.series_params_from_metadata(
        tmeta, np.asarray(d["true"].particle_pos), d["eulers"], device=CPU)
    np.testing.assert_allclose(cp.tilt_shifts.numpy(), shifts, atol=1e-6)
    other = cp._replace(tilt_shifts=-cp.tilt_shifts)
    good = tcsp.csp_refine(cp, d["images"], d["defocus"], vol, PIXEL, NBOX,
                           modes=(3,), iters_per_mode=0, device=CPU)[1][0]
    bad = tcsp.csp_refine(other, d["images"], d["defocus"], vol, PIXEL, NBOX,
                          modes=(3,), iters_per_mode=0, device=CPU)[1][0]
    assert good > bad + 0.1, (good, bad)
    # the refined shifts go back with the same sign
    refined, _, _ = tpipe.csp_swarm_one(
        item_of(d, "ts"), params(), vol, tmp_path, device=CPU)
    back = TMeta("ts", tmp_path, mode="tomo").load()
    np.testing.assert_allclose(
        -sign * back["xf"][:, :2], refined.tilt_shifts.numpy(), atol=1e-5)
    assert "xf_shift_sign" in back.scalars and meta.exists()


def test_bundles_cross_between_packages(planted, tmp_path):
    """A bundle the JAX package wrote (no sign scalar) reads into the same
    parameters in both packages; the port's refined bundle reads back in
    the JAX package as the port's refined parameters."""
    vol, d = planted
    shifts = np.asarray(d["true"].tilt_shifts)
    d = dict(d, xf=np.concatenate([shifts + 0.5, np.full((T, 1), 2.0)],
                                  axis=1).astype(np.float32))
    write_bundle(d, "ts", tmp_path)
    from pyp_tpu_torch.io.metadata import ItemMetadata as TMeta

    pos = np.asarray(d["true"].particle_pos)
    pj = jpipe.series_params_from_metadata(
        ItemMetadata("ts", tmp_path, mode="tomo").load(), pos, d["eulers"])
    pt = tpipe.series_params_from_metadata(
        TMeta("ts", tmp_path, mode="tomo").load(), pos, d["eulers"],
        device=CPU)
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    refined, _, _ = tpipe.csp_swarm_one(item_of(d, "ts"), params(), vol,
                                        tmp_path, device=CPU)
    back = jpipe.series_params_from_metadata(
        ItemMetadata("ts", tmp_path, mode="tomo").load(), pos, d["eulers"])
    np.testing.assert_allclose(np.asarray(back.tilt_shifts),
                               refined.tilt_shifts.numpy(), atol=1e-6)
    np.testing.assert_allclose(np.asarray(back.tilt_angles),
                               refined.tilt_angles.numpy(), atol=1e-6)


def test_random_start_is_the_same_in_every_process(tmp_path, monkeypatch):
    """The random start eulers of a series (and the batch's particle
    subsampling) come from a crc32 of its name, which Python does not
    salt: a process with another hash seed (this one's is random) draws
    the same ones."""
    from pyp_tpu_torch import cli as tcli
    from pyp_tpu_torch.io import mrc
    from pyp_tpu_torch.io.metadata import ItemMetadata as TMeta

    monkeypatch.chdir(tmp_path)
    mrc.write(np.zeros((3, 32, 32), np.float32), "ts9.mrc")
    meta = TMeta("ts9", tmp_path, mode="tomo")
    meta["box"], meta["tlt"] = np.full((5, 3), 16.0), np.zeros(3)
    meta.save()
    p = {"tomo_pick_rand": True, "tomo_rec_thickness": 32}
    here = tcli._csp_load_item({"name": "ts9", "path": "ts9.mrc"}, p)[0]
    want = np.random.RandomState(zlib.crc32(b"ts9") % 2 ** 31).uniform(
        0, 360, (5, 3)).astype(np.float32)
    np.testing.assert_array_equal(here["eulers"], want)
    assert tpipe.stable_seed("ts9") == zlib.crc32(b"ts9") % 2 ** 31
    code = ("import numpy as np, sys; sys.path.insert(0, %r);"
            "from pyp_tpu_torch import cli;"
            "e = cli._csp_load_item({'name': 'ts9', 'path': 'ts9.mrc'},"
            " {'tomo_pick_rand': True, 'tomo_rec_thickness': 32})[0]['eulers'];"
            "print(repr(e.tolist()))" % REPO)
    for seed in ("1",):
        out = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            cwd=tmp_path, check=True,
            env={**os.environ, "PYTHONHASHSEED": seed}).stdout
        np.testing.assert_array_equal(
            np.asarray(eval(out.strip().splitlines()[-1]), np.float32), want)


def test_zero_transreg_turns_the_penalty_off():
    """-csp_transreg 0 means no trajectory penalty in the port; the JAX
    package reads 0 as its default 0.1 (`or 0.1`)."""
    p = dict(params(), csp_transreg=0.0)
    assert tpipe._csp_config(p, 2, PIXEL)["reg_weight"] == 0.0
    assert jpipe._csp_config(p, 2, PIXEL)["reg_weight"] == 0.1
    p = dict(params(), csp_transreg=0.3)
    assert (tpipe._csp_config(p, 2, PIXEL)["reg_weight"]
            == jpipe._csp_config(p, 2, PIXEL)["reg_weight"] == 0.3)
    p = params()
    del p["csp_transreg"]
    assert tpipe._csp_config(p, 2, PIXEL)["reg_weight"] == 0.1
