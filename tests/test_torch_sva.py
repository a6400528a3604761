"""Parity of pyp_tpu_torch/ops/sva.py and the `sva` mode with the JAX
package on the CPU: the score block's argmax and shift (ties to the first
angle), global alignment, local refinement, centering, k-means
classification with the same seed, the wedge-compensated average, the
whole loop, and `cli.main(["sva", ...])` in both packages on one
tomogram. The subvolumes are the JAX tests' own phantom
(`tests/test_sva._phantom`, box 16 here) turned, shifted and wedged.

Tolerances: chosen angles and integer shifts equal (refined shifts,
composed through the float32 prior rotation, within 1e-4), scores within
1e-4;
averages within 1e-4 * max|reference| (the trilinear resampler and FFTs
in another order); refined angles within 1e-3° (composed in float32);
labels equal.
"""

import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyp_tpu import cli as jcli
from pyp_tpu.io import mrc as jmrc
from pyp_tpu.io.metadata import ItemMetadata
from pyp_tpu.ops import sva as jsva
from pyp_tpu.ops.template_match import rotate_volume
from pyp_tpu_torch import cli as tcli
from pyp_tpu_torch.ops import sva as tsva
from tests.test_sva import _make_subvols, _phantom

CPU = "cpu"
NB = 16


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.as_tensor(np.array(x))


def close(a, b, rel=1e-4):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * np.abs(b).max())


@pytest.fixture(scope="module")
def subvols():
    truth = _phantom(NB)
    subs, angles, shifts = _make_subvols(truth, 6, 60.0, 0.1, seed=1)
    return truth, subs.astype(np.float32), angles, shifts


def test_score_block_matches_and_breaks_ties_first(subvols):
    truth, subs, _, _ = subvols
    rng = np.random.RandomState(0)
    bank = np.stack([np.asarray(rotate_volume(jnp.asarray(truth), *a))
                     for a in rng.uniform(0, 180, (5, 3))])
    bank[3] = bank[1]          # a tied pair of angles: the first wins
    bank = bank - bank.mean((1, 2, 3), keepdims=True)
    bank /= np.sqrt((bank ** 2).sum((1, 2, 3), keepdims=True))
    SubF = np.fft.rfftn(subs, axes=(-3, -2, -1)).astype(np.complex64)
    norm = np.sqrt((subs ** 2).sum((1, 2, 3))).astype(np.float32)
    cj, aj, sj = jsva._score_block(jnp.asarray(SubF), jnp.asarray(bank),
                                   jnp.asarray(norm), 3)
    ct, at, st = tsva._score_block(t(SubF), t(bank), t(norm), 3)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-4,
                               atol=1e-5)
    assert 3 not in at.numpy()


@pytest.fixture(scope="module")
def aligned(subvols):
    truth, subs, _, _ = subvols
    kw = dict(angular_step=60.0, shift_extent=3, wedge_deg=60.0,
              mask_sigma=2.0)
    return (jsva.align_subvolumes(subs, truth, **kw),
            tsva.align_subvolumes(subs, truth, device=CPU, **kw))


def test_align_subvolumes_matches(aligned):
    (aj, sj, cj), (at, st, ct) = aligned
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=1e-4)


def test_refine_and_center_match(subvols, aligned):
    truth, subs, _, _ = subvols
    (aj, sj, _), _ = aligned
    kw = dict(tol_angle=30.0, step=15.0, shift_extent=2, wedge_deg=60.0)
    rj = jsva.refine_subvolumes(subs, truth, np.asarray(aj), np.asarray(sj),
                                **kw)
    rt = tsva.refine_subvolumes(subs, truth, np.asarray(aj), np.asarray(sj),
                                device=CPU, **kw)
    np.testing.assert_allclose(rt[0].numpy(), np.asarray(rj[0]), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(rt[1].numpy(), np.asarray(rj[1]), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(rt[2].numpy(), np.asarray(rj[2]), rtol=0,
                               atol=1e-4)
    shj, refj = jsva.center_subvolumes(subs, iters=2, shift_extent=3,
                                       wedge_deg=60.0)
    sht, reft = tsva.center_subvolumes(subs, iters=2, shift_extent=3,
                                       wedge_deg=60.0, device=CPU)
    np.testing.assert_array_equal(sht, np.asarray(shj))
    close(reft, refj)


def test_average_and_classify_match(subvols):
    truth, subs, angles, shifts = subvols
    w = np.linspace(0.5, 1.0, len(subs))
    close(tsva.average_subvolumes(subs, angles, shifts, wedge_deg=60.0,
                                  score_weights=w, device=CPU),
          jsva.average_subvolumes(subs, angles, shifts, wedge_deg=60.0,
                                  score_weights=w))
    # two states, k-means from the same seed
    rng = np.random.RandomState(4)
    b_state = np.roll(truth, 4, axis=1)
    two = np.stack([(truth if b % 2 == 0 else b_state)
                    + 0.3 * rng.randn(NB, NB, NB) for b in range(8)]
                   ).astype(np.float32)
    z = np.zeros((8, 3))
    lj, avj = jsva.classify_subvolumes(two, z, z, 2, wedge_deg=90.0, seed=3)
    lt, avt = tsva.classify_subvolumes(two, z, z, 2, wedge_deg=90.0, seed=3,
                                       device=CPU)
    np.testing.assert_array_equal(lt, lj)
    for a, b in zip(avt, avj):
        close(a, b)


@pytest.mark.parametrize("reference", [False, True], ids=["free", "ref"])
def test_sva_iterate_matches(subvols, reference):
    truth, subs, _, _ = subvols
    kw = dict(reference=truth if reference else None, iters=2,
              angular_step=60.0, shift_extent=3, wedge_deg=60.0,
              keep_fraction=0.8, centering_iters=0 if reference else 1)
    rj = jsva.sva_iterate(subs, **kw)
    rt = tsva.sva_iterate(subs, device=CPU, **kw)
    np.testing.assert_allclose(rt.angles.numpy(), np.asarray(rj.angles),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(rt.shifts.numpy(), np.asarray(rj.shifts),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(rt.scores.numpy(), np.asarray(rj.scores),
                               rtol=0, atol=1e-4)
    close(rt.average, rj.average)


def test_sva_mode_matches_jax(subvols, tmp_path, capsys, monkeypatch):
    """`sva` in both packages on one tomogram with three 3D picks, with two
    classes."""
    truth = subvols[0]
    rng = np.random.RandomState(3)
    base = tmp_path / "base"
    base.mkdir()
    vol = 0.1 * rng.randn(32, 48, 48).astype(np.float32)
    centers = [(16, 14, 14), (16, 14, 34), (16, 34, 24)]
    for cz, cy, cx in centers:
        a = rng.uniform(0, 180, 3)
        r = np.asarray(rotate_volume(jnp.asarray(truth), *a))
        vol[cz - 8:cz + 8, cy - 8:cy + 8, cx - 8:cx + 8] += r
    jmrc.write(vol, base / "t1.rec.mrc", pixel_size=2.0)
    meta = ItemMetadata("t1", base, mode="tomo")
    meta["box"] = np.asarray([(z, y, x, 1.0) for z, y, x in centers],
                             np.float32)
    meta.save()
    argv = ["sva", "-scope_pixel", "2.0", "-sva_box", str(NB),
            "-sva_iters", "2", "-sva_ang", "60", "-sva_shift", "2",
            "-sva_wedge", "60", "-sva_classes", "2", "-data_set", "t"]
    out = {}
    for pkg, cli, kw in (("jax", jcli, {}), ("port", tcli, {"device": CPU})):
        where = tmp_path / pkg
        shutil.copytree(base, where)
        monkeypatch.chdir(where)
        assert cli.main(argv, **kw) == 0
        text = capsys.readouterr().out
        out[pkg] = (json.loads(text[text.rindex("{"):]), where)
    (rj, wj), (rt, wt) = out["jax"], out["port"]
    assert rt["subvolumes"] == rj["subvolumes"] == 3
    assert rt["classes"] == rj["classes"]
    assert abs(rt["mean_score"] - rj["mean_score"]) < 1e-4
    for name in ("t_sva.mrc", "t_sva_class00.mrc", "t_sva_class01.mrc"):
        close(jmrc.read(wt / name), jmrc.read(wj / name))
    at, aj = np.load(wt / "sva_alignment.npz"), np.load(wj / "sva_alignment.npz")
    np.testing.assert_array_equal(at["names"], aj["names"])
    np.testing.assert_array_equal(at["labels"], aj["labels"])
    np.testing.assert_allclose(at["angles"], aj["angles"], rtol=0, atol=1e-3)
