"""Parity of pyp_tpu_torch.postprocess.locres and ops.extract against the
JAX package on the CPU, and the JAX oracles of tests/test_locres.py run on
the port.

Half maps (box 48, 2 Å per pixel; the two quality oracles at
tests/test_locres.py's box 96) carry a resolution gradient along x: the
left half of the box signal to ~6 Å, the right half to ~20 Å, beyond its
band independent noise in each half (tests/test_locres.py's construction
at a smaller box). Phases are JAX's where a test patches the port's
`_random_phases` (`same_phases`).

Tolerances: windows, window FSCs and interpolations to float rounding
(atol 1e-5, FSC 1e-4); per-point resolutions within 1e-3 Å; the local
resolution and locally filtered maps atol 1e-3 * max|map|; unpatched, the
median local resolution within 5% of JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_postprocess import jax_phases

from pyp_tpu.core.filters import lowpass_filter_3d
from pyp_tpu.io import mrc
from pyp_tpu.ops.extract import subvolume_gather as j_gather
from pyp_tpu.postprocess import locres as jloc
from pyp_tpu_torch.ops.extract import subvolume_gather as t_gather
from pyp_tpu_torch.postprocess import core as tpost
from pyp_tpu_torch.postprocess import locres as tloc

N = 48
PIXEL = 2.0


def make_halves(seed=0, n=N):
    rng = np.random.RandomState(seed)
    base = rng.randn(n, n, n).astype(np.float32)
    hi = np.asarray(lowpass_filter_3d(jnp.asarray(base), PIXEL, 6.0))
    lo = np.asarray(lowpass_filter_3d(jnp.asarray(base), PIXEL, 20.0))
    ramp = np.zeros((1, 1, n), dtype=np.float32)
    ramp[..., : n // 2] = 1.0
    signal = hi * ramp + lo * (1.0 - ramp)
    noise_amp = 0.15 * signal.std()
    h1 = signal + noise_amp * rng.randn(n, n, n).astype(np.float32)
    h2 = signal + noise_amp * rng.randn(n, n, n).astype(np.float32)
    return signal, h1, h2


@pytest.fixture(scope="module")
def halves():
    return make_halves()


@pytest.fixture
def same_phases(monkeypatch):
    monkeypatch.setattr(tpost, "_random_phases", jax_phases)


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def close(port, ref, atol_rel=1e-5):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    np.testing.assert_allclose(port, ref, rtol=0,
                               atol=atol_rel * float(np.abs(ref).max()))


@pytest.mark.parametrize("box", [8, 16])
def test_subvolume_gather(box):
    vol = np.random.RandomState(0).randn(20, 24, 28).astype(np.float32)
    # inside, at the low and high edges (clamped), and past them
    coords = np.array([[10, 12, 14], [0, 0, 0], [19, 23, 27], [3, 20, 9],
                       [-4, 30, 40]], np.int32)
    close(t_gather(t(vol), torch.as_tensor(coords), box),
          j_gather(jnp.asarray(vol), jnp.asarray(coords), box), 0)


def test_batched_window_fsc_and_resolutions(halves):
    _, h1, h2 = halves
    pts = np.array([[12, 12, 12], [24, 24, 30], [30, 20, 10]], np.int32)
    w1 = np.asarray(j_gather(jnp.asarray(h1), jnp.asarray(pts), 16))
    w2 = np.asarray(j_gather(jnp.asarray(h2), jnp.asarray(pts), 16))
    ref = np.asarray(jloc._batched_window_fsc(jnp.asarray(w1), jnp.asarray(w2), 8))
    out = tloc._batched_window_fsc(t(w1), t(w2), 8)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)
    # a curve that never crosses reads Nyquist
    curves = np.concatenate([ref, np.ones((1, 8), np.float32)])
    for thr in (0.143, 0.5):
        np.testing.assert_allclose(
            tloc._resolutions_at_threshold(t(curves), PIXEL, thr).numpy(),
            np.asarray(jloc._resolutions_at_threshold(jnp.asarray(curves), PIXEL, thr)),
            atol=1e-3)


def test_interp_matches_jnp_interp():
    rng = np.random.RandomState(1)
    xp = np.sort(rng.uniform(-3, 9, 7)).astype(np.float32)
    fp = rng.randn(7).astype(np.float32)
    x = np.concatenate([rng.uniform(-6, 12, 200), xp]).astype(np.float32)
    np.testing.assert_allclose(tloc._interp(t(x), t(xp), t(fp)).numpy(),
                               np.asarray(jnp.interp(x, xp, fp)), atol=1e-5)


def test_trilinear_matches_map_coordinates():
    """A non-cubic coarse grid, coordinates inside and beyond its edges
    (clamped as mode="nearest")."""
    rng = np.random.RandomState(2)
    coarse = rng.randn(3, 5, 4).astype(np.float32)
    zz, yy, xx = (rng.uniform(-1, d, (6, 7, 8)).astype(np.float32)
                  for d in coarse.shape)
    ref = jax.scipy.ndimage.map_coordinates(jnp.asarray(coarse),
                                            [zz, yy, xx], order=1,
                                            mode="nearest")
    close(tloc._trilinear_nearest(t(coarse), t(zz), t(yy), t(xx)), ref)


@pytest.mark.parametrize("kw", [{"sampling_a": 16.0},
                                {"sampling_a": 20.0, "maskrad_a": 8.0,
                                 "edgwidth_a": 6.0, "randomize_at_a": 15.0,
                                 "threshold": 0.5, "batch": 5}],
                         ids=["default", "options"])
def test_local_resolution(halves, same_phases, kw):
    _, h1, h2 = halves
    lr_j, pts_j, v_j = jloc.local_resolution(h1, h2, PIXEL, **kw)
    lr_t, pts_t, v_t = tloc.local_resolution(t(h1), t(h2), PIXEL, device="cpu", **kw)
    np.testing.assert_array_equal(pts_t, np.asarray(pts_j))
    np.testing.assert_allclose(v_t, np.asarray(v_j), atol=1e-3)
    close(lr_t, lr_j, 1e-3)


def test_randomize_beyond(halves, same_phases):
    _, h1, _ = halves
    close(tloc._randomize_beyond(t(h1), PIXEL, 12.0, seed=4),
          jloc._randomize_beyond(h1, PIXEL, 12.0, seed=4), 1e-4)


def test_local_filter(halves):
    _, h1, h2 = halves
    lr = np.asarray(jloc.local_resolution(h1, h2, PIXEL, sampling_a=16.0)[0])
    comb = 0.5 * (h1 + h2)
    close(tloc.local_filter(t(comb), t(lr), PIXEL),
          jloc.local_filter(comb, lr, PIXEL), 1e-4)
    # a flat resolution map is one lowpass
    flat = np.full_like(lr, 9.0)
    close(tloc.local_filter(t(comb), t(flat), PIXEL),
          jloc.local_filter(comb, flat, PIXEL), 1e-4)


def test_unpatched_median_agrees(halves):
    _, h1, h2 = halves
    _, _, v_j = jloc.local_resolution(h1, h2, PIXEL, sampling_a=16.0)
    _, _, v_t = tloc.local_resolution(t(h1), t(h2), PIXEL, device="cpu", sampling_a=16.0)
    assert abs(np.median(v_t) - np.median(v_j)) <= 0.05 * np.median(v_j)


ORACLE_N = 96  # tests/test_locres.py's box: its bars need windows that
# do not straddle the boundary between the zones


def test_separates_hi_and_lo_res_regions():
    """tests/test_locres.py's oracle on the port: the 6 Å left zone reads
    finer than the 20 Å right zone, every value inside the clamp."""
    n = ORACLE_N
    _, h1, h2 = make_halves(n=n)
    locres, _, values = tloc.local_resolution(t(h1), t(h2), PIXEL, device="cpu",
                                              sampling_a=16.0, minres_a=50.0)
    locres = locres.numpy()
    assert locres.shape == (n, n, n)
    assert np.all(values >= 2 * PIXEL - 1e-6) and np.all(values <= 50.0 + 1e-6)
    left = np.median(locres[:, :, : n // 4])
    right = np.median(locres[:, :, 3 * n // 4:])
    assert left < 6.0 and right > 1.8 * left, (left, right)


def test_local_filter_beats_unfiltered():
    """tests/test_locres.py's oracle on the port: filtering at the local
    resolution lowers the error against the truth in the soft zone and
    keeps the sharp zone."""
    n = ORACLE_N
    signal, h1, h2 = make_halves(seed=3, n=n)
    comb = 0.5 * (h1 + h2)
    locres, _, _ = tloc.local_resolution(t(h1), t(h2), PIXEL, device="cpu", sampling_a=16.0)
    filt = tloc.local_filter(t(comb), locres, PIXEL).numpy()
    left = slice(None), slice(None), slice(0, n // 4)
    right = slice(None), slice(None), slice(2 * n // 3, 11 * n // 12)

    def err(v, region):
        return float(np.linalg.norm((v - signal)[region]))

    assert err(filt, right) < 0.65 * err(comb, right)
    assert err(filt, left) < err(comb, left)
    cc_filt = np.corrcoef(filt[left].ravel(), signal[left].ravel())[0, 1]
    cc_comb = np.corrcoef(comb[left].ravel(), signal[left].ravel())[0, 1]
    assert cc_filt >= cc_comb - 1e-4, (cc_filt, cc_comb)


def test_postprocess_locres_files(halves, tmp_path, same_phases):
    """postprocess_latest with sharpen_locres in both packages: the same
    _locres.mrc and _locfilt.mrc files, within the map tolerance."""
    _, h1, h2 = halves
    params = {"sharpen_locres": True, "sharpen_locres_sampling": 20.0,
              "plot_per_item": False, "sharpen_resmap_max_res": 5.0}
    outs = {}
    for name in ("jax", "port"):
        maps = tmp_path / name / "maps"
        maps.mkdir(parents=True)
        mrc.write(h1, maps / "ds_r01_02_half1.mrc", pixel_size=PIXEL)
        mrc.write(h2, maps / "ds_r01_02_half2.mrc", pixel_size=PIXEL)
        if name == "jax":
            from pyp_tpu.postprocess.core import postprocess_latest
            outs[name] = postprocess_latest("ds", dict(params), tmp_path / name)
        else:
            outs[name] = tpost.postprocess_latest("ds", dict(params),
                                                  tmp_path / name, device="cpu")
    oj, ot = outs["jax"], outs["port"]
    assert ot["locres_median_A"] == pytest.approx(oj["locres_median_A"], abs=1e-3)
    for key in ("locres_map", "locfilt_map"):
        close(mrc.read(ot[key]), mrc.read(oj[key]), 1e-3)
