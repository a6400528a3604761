"""Parity of pyp_tpu_torch/pipeline/csp.py and the `csp` mode with the JAX
package on the CPU: one series through csp_swarm_one, two through
csp_swarm_batch, the merge, patch regions, and `cli.main(["csp", ...])`
in both packages on one bundle (maps, FSC, the updated xf / tlt /
csp_scores and the ArtiaX star). The series are the JAX tests' own
(`tests/test_csp.make_tilt_series`: 7 tilts of 160², 6 particles, box 24
at 2 Å/px). The bundles carry no `xf_shift_sign` (as the JAX package
writes them), and the start eulers are given (item or -csp_parfile), so
no run leans on Python's salted `hash`.

Tolerances: refined parameters within 1e-3 of their scale (3 steps a
mode, float32 gathers summed in another order), mode and particle scores
within 1e-4, maps within 3e-3 * max|reference| after a low-pass to 0.85
Nyquist (the windows are inserted at poses that agree to 1e-3, and a
sample on the Nyquist ring falls inside or outside the insertion sphere
by the last bit of its coordinates), FSC(0.143) within
one shell, the ArtiaX star's numbers within 2e-3 (written to 3 decimals).
"""

import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyp_tpu import cli as jcli
from pyp_tpu.config.params import defaults
from pyp_tpu.io import cistem as jcistem
from pyp_tpu.io import mrc as jmrc
from pyp_tpu.io.metadata import ItemMetadata
from pyp_tpu.pipeline import csp as jpipe
from pyp_tpu_torch import cli as tcli
from pyp_tpu_torch.pipeline import csp as tpipe
from tests.test_csp import NBOX, PIXEL, P, T, make_reference, make_tilt_series

CPU = "cpu"
NZ = 64          # tomo_rec_thickness of the bundles' tomogram (unbinned px)
PARAMS = {"scope_pixel": PIXEL, "csp_box": NBOX, "csp_rlref": 60.0,
          "csp_rhref": "5", "csp_OptimizerIters": 3, "csp_transreg": 0.05,
          "csp_refine_modes": "3:1"}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def lowpass(vol, frac=0.85):
    f = np.fft.fftfreq(vol.shape[0])
    r = np.sqrt(f[:, None, None] ** 2 + f[None, :, None] ** 2
                + f[None, None, :] ** 2)
    return np.real(np.fft.ifftn(np.fft.fftn(vol) * (r <= 0.5 * frac)))


def close_maps(a, b):
    a, b = lowpass(np.asarray(a)), lowpass(np.asarray(b))
    np.testing.assert_allclose(a, b, rtol=0, atol=3e-3 * np.abs(b).max())


def assert_params(pt, pj, atol=1e-3, scale_defocus=100.0):
    for k, (a, b) in enumerate(zip(pt, pj)):
        tol = atol * (scale_defocus if k == 5 else 1.0)
        np.testing.assert_allclose(a.cpu().numpy(), np.asarray(b), rtol=0,
                                   atol=tol)


@pytest.fixture(scope="module")
def data():
    vol = make_reference()
    true, images, defocus = make_tilt_series(vol, seed=1, noise=0.08)
    out = []
    for seed in (1, 2):
        # two series: one planted set, two starts (the alignment's and the
        # eulers' errors differ)
        rng = np.random.RandomState(seed + 10)
        out.append(dict(
            true=true, images=np.asarray(images), defocus=np.asarray(defocus),
            xf=np.concatenate([
                np.asarray(true.tilt_shifts) + rng.uniform(-1.0, 1.0, (T, 2)),
                np.full((T, 1), 2.0)], axis=1).astype(np.float32),
            eulers=(np.asarray(true.particle_eulers)
                    + rng.uniform(-4, 4, (P, 3))).astype(np.float32)))
    return vol, out


def write_bundle(d, name, where, sign=None):
    meta = ItemMetadata(name, where, mode="tomo")
    meta["tlt"] = np.asarray(d["true"].tilt_angles)
    meta["xf"] = d["xf"]
    meta["ctf"] = np.concatenate([d["defocus"], np.zeros((T, 3), np.float32)],
                                 axis=1)
    # the picks: centred positions on the NZ-slice tomogram, binning 1
    centre = np.array([NZ / 2, d["images"].shape[-2] / 2,
                       d["images"].shape[-1] / 2])
    meta["box"] = np.asarray(d["true"].particle_pos) + centre
    meta.scalars["binning"] = 1.0
    if sign is not None:
        meta.scalars["xf_shift_sign"] = float(sign)
    meta.save()


def params():
    p = defaults()
    p.update(PARAMS)
    return p


def item_of(d, name):
    return {"name": name, "tilts": d["images"],
            "coords": np.asarray(d["true"].particle_pos),
            "eulers": d["eulers"]}


@pytest.fixture(scope="module")
def swarm_one(data, tmp_path_factory):
    vol, ds = data
    out = {}
    for pkg in ("jax", "port"):
        where = tmp_path_factory.mktemp(pkg)
        write_bundle(ds[0], "ts1", where)
        if pkg == "jax":
            r = jpipe.csp_swarm_one(item_of(ds[0], "ts1"), params(), vol,
                                    where)
        else:
            r = tpipe.csp_swarm_one(item_of(ds[0], "ts1"), params(), vol,
                                    where, device=CPU)
        out[pkg] = (r, ItemMetadata("ts1", where, mode="tomo").load())
    return out


def test_csp_swarm_one_matches(swarm_one):
    (rj, acc_j, sj), mj = swarm_one["jax"]
    (rt, acc_t, st), mt = swarm_one["port"]
    assert_params(rt, rj)
    np.testing.assert_allclose(st, sj, rtol=0, atol=1e-4)
    for k in ("xf", "tlt", "csp_scores"):
        np.testing.assert_allclose(mt[k], mj[k], rtol=0, atol=1e-3)


def test_csp_merge_matches(swarm_one, tmp_path):
    (_, acc_j, _), _ = swarm_one["jax"]
    (_, acc_t, _), _ = swarm_one["port"]
    out_j, res_j = jpipe.csp_merge([acc_j], NBOX, params(), tmp_path / "j")
    out_t, res_t = tpipe.csp_merge([acc_t], NBOX, params(), tmp_path / "t")
    for a, b in ((out_t.half1, out_j.half1), (out_t.half2, out_j.half2)):
        close_maps(a.numpy(), b)
    # one FSC shell at box 24, 2 Å/px is ~2 Å near 8 Å
    assert abs(res_t - res_j) < 2.0 + 1e-6, (res_t, res_j)
    for suffix in ("", "_half1", "_half2"):
        name = f"maps/dataset_csp_02{suffix}.mrc"
        close_maps(jmrc.read(tmp_path / "t" / name),
                   jmrc.read(tmp_path / "j" / name))


def test_csp_swarm_batch_matches(data, tmp_path):
    """Two series refined together: the port's vectorized batch against
    JAX's sequential one (test_torch_csp_search.py holds the port's
    vectorized batch to its sequential one)."""
    vol, ds = data
    res = {}
    for pkg in ("jax", "port"):
        where = tmp_path / pkg
        items = []
        for k, d in enumerate(ds):
            write_bundle(d, f"ts{k}", where)
            items.append(item_of(d, f"ts{k}"))
        if pkg == "jax":
            res[pkg] = jpipe.csp_swarm_batch(items, params(), vol, where)
        else:
            res[pkg] = tpipe.csp_swarm_batch(items, params(), vol, where,
                                             device=CPU)
    (rj, acc_j, sj, pj), (rt, acc_t, st, pt) = res["jax"], res["port"]
    for a, b in zip(rt, rj):
        assert_params(a, b)
    np.testing.assert_allclose(np.asarray(st), np.asarray(sj), rtol=0,
                               atol=1e-4)
    for a, b in zip(pt, pj):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    out_j, _ = jpipe.csp_merge([acc_j], NBOX, params(), tmp_path / "mj")
    out_t, _ = tpipe.csp_merge([acc_t], NBOX, params(), tmp_path / "mt")
    close_maps(out_t.volume.numpy(), out_j.volume)


def test_csp_refine_regions_match(data):
    """Patch regions (modes 5 and 6 on a 2 x 1 x 1 grid): the per-region
    refinements and the stitched record."""
    from pyp_tpu.ops import csp as jcsp
    from pyp_tpu_torch.ops import csp as tcsp

    vol, ds = data
    d = ds[0]
    start = d["true"]._replace(tilt_shifts=jnp.asarray(d["xf"][:, :2]))
    kw = dict(grid=(2, 1, 1), modes=(5, 6), iters_per_mode=2,
              high_res=2.5 * PIXEL)
    per_j, reg_j = jpipe.csp_refine_regions(
        start, d["images"], d["defocus"], vol, PIXEL, NBOX, **kw)
    per_t, reg_t = tpipe.csp_refine_regions(
        tcsp.make_params(*(np.asarray(x) for x in start), device=CPU),
        d["images"], d["defocus"], vol, PIXEL, NBOX, device=CPU, **kw)
    np.testing.assert_array_equal(reg_t, reg_j)
    assert len(per_t) == len(per_j) == 2
    for a, b in zip(per_t, per_j):
        assert (a is None) == (b is None)
        if a is not None:
            assert_params(a, b)
    st = tpipe._stitch_regions(
        tcsp.make_params(*(np.asarray(x) for x in start), device=CPU),
        per_t, reg_t)
    sj = jpipe._stitch_regions(start, per_j, reg_j)
    assert_params(st, sj)
    assert jcsp.MODE_BLOCKS == tcsp.MODE_BLOCKS


def run_cli(cli, argv, where, capsys, monkeypatch, **kw):
    monkeypatch.chdir(where)
    rc = cli.main(argv, **kw)
    lines = [ln for ln in capsys.readouterr().out.splitlines()]
    text = "\n".join(lines)
    return rc, json.loads(text[text.index("{"):])


def read_star(path):
    rows = [ln.split("\t") for ln in path.read_text().splitlines()
            if ln.startswith("ts1\t")]
    return np.array([[float(v) for v in r[1:]] for r in rows])


def test_csp_mode_matches_jax(data, tmp_path, capsys, monkeypatch):
    """`csp` through both packages' CLI on one bundle with its stack and a
    -csp_parfile start."""
    vol, ds = data
    d = ds[0]
    base = tmp_path / "base"
    base.mkdir()
    jmrc.write(d["images"], base / "ts1.mrc", pixel_size=PIXEL)
    jmrc.write(vol, base / "initial_model.mrc", pixel_size=PIXEL)
    table = jcistem.Table.zeros(P)
    table["phi"], table["theta"], table["psi"] = d["eulers"].T
    jcistem.write_parameters(table, base / "start.cistem")
    write_bundle(d, "ts1", base)
    argv = ["csp", "-data_path", "ts1.mrc", "-csp_parfile", "start.cistem",
            "-tomo_rec_thickness", str(NZ), "-tomo_rec_binning", "4",
            "-scope_pixel", str(PIXEL), "-csp_box", str(NBOX),
            "-csp_rhref", "5", "-csp_OptimizerIters", "3",
            "-csp_refine_modes", "3:1", "-csp_transreg", "0.05"]
    out = {}
    for pkg, cli, kw in (("jax", jcli, {}), ("port", tcli, {"device": CPU})):
        where = tmp_path / pkg
        shutil.copytree(base, where)
        rc, summary = run_cli(cli, argv, where, capsys, monkeypatch, **kw)
        assert rc == 0
        out[pkg] = (summary, where)
    (sj, wj), (st, wt) = out["jax"], out["port"]
    assert st["series"] == sj["series"] == 1 and not st["missing"]
    assert abs(st["resolution"] - sj["resolution"]) < 2.0 + 1e-6
    for suffix in ("", "_half1", "_half2"):
        name = f"maps/dataset_csp_02{suffix}.mrc"
        close_maps(jmrc.read(wt / name), jmrc.read(wj / name))
    mj = ItemMetadata("ts1", wj, mode="tomo").load()
    mt = ItemMetadata("ts1", wt, mode="tomo").load()
    for k in ("xf", "tlt", "csp_scores"):
        np.testing.assert_allclose(mt[k], mj[k], rtol=0, atol=1e-3)
    star_j = read_star(wj / "artiax" / "ts1_K1.star")
    star_t = read_star(wt / "artiax" / "ts1_K1.star")
    np.testing.assert_allclose(star_t, star_j, rtol=0, atol=2e-3)
    assert (wt / "swarm" / "ts1.acc.npz").exists()
    # -csp_resume: the series is not refined and the merge not run again
    # (the port's maps are newer than its dump); the summary is the same
    mtime = (wt / "maps" / "dataset_csp_02.mrc").stat().st_mtime_ns
    rc, again = run_cli(tcli, argv + ["-csp_resume"], wt, capsys,
                        monkeypatch, device=CPU)
    assert rc == 0 and again["resumed"]
    assert again["resolution"] == pytest.approx(st["resolution"], abs=1e-6)
    assert (wt / "maps" / "dataset_csp_02.mrc").stat().st_mtime_ns == mtime
