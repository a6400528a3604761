"""Parity of pyp_tpu_torch.ops.pick and ops.extract against the JAX
package's on the CPU: the same seeded numpy micrographs (512², planted
Gaussian blobs in white noise) go through the JAX function and its torch
port.

Tolerances: window means and maxima 1e-5 relative to max|reference| (the
separable two-pass sums add in another order than the 2-D window); picks
compared as sets of valid (y, x) coordinates, their scores within 1e-4;
extracted stacks atol 1e-4 * max|reference|; medians exact. Recovery
tests hold the port alone to the planted particles.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyp_tpu.ops import extract as je
from pyp_tpu.ops import pick as jp
from pyp_tpu_torch.ops import extract as te
from pyp_tpu_torch.ops import pick as tp


def close(port, ref, rtol=1e-4, atol_rel=1e-4):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    atol = atol_rel * max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol)


def make_micrograph(n=512, n_particles=20, radius=16, contrast=-3.0, seed=0):
    rng = np.random.RandomState(seed)
    img = rng.randn(n, n).astype(np.float32)
    ax = np.arange(-radius * 2, radius * 2 + 1)
    blob = np.exp(-(ax[:, None] ** 2 + ax[None, :] ** 2) / (radius * radius / 1.5))
    coords = []
    while len(coords) < n_particles:
        y, x = rng.randint(radius * 3, n - radius * 3, 2)
        if all(abs(y - cy) + abs(x - cx) > radius * 4 for cy, cx in coords):
            coords.append((y, x))
    for y, x in coords:
        img[y - 2 * radius: y + 2 * radius + 1,
            x - 2 * radius: x + 2 * radius + 1] += contrast * blob
    return img, np.array(coords)


@pytest.fixture(scope="module")
def mic():
    return make_micrograph()


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def valid_set(res):
    coords = np.asarray(res.coords)[np.asarray(res.valid)]
    return {(int(y), int(x)) for y, x in coords}


@pytest.mark.parametrize("shape", [(101,), (100,), (7, 64), (6, 33), (3, 4, 10)])
def test_median_is_numpy_s(shape):
    """Even counts average the two middle values, as jnp.median does."""
    x = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    np.testing.assert_array_equal(tp.median(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.median(jnp.asarray(x), axis=-1)))
    if len(shape) > 1:
        np.testing.assert_array_equal(
            tp.median(torch.from_numpy(x), dim=0).numpy(),
            np.asarray(jnp.median(jnp.asarray(x), axis=0)))


@pytest.mark.parametrize("radius", [1, 8, 40, 100])
def test_disk_mean_and_local_maxima(mic, radius):
    img = mic[0][:200, :232]
    close(tp._disk_mean(torch.from_numpy(img), radius),
          jp._disk_mean(jnp.asarray(img), radius), rtol=1e-5, atol_rel=1e-5)
    smooth = np.asarray(jp._disk_mean(jnp.asarray(img), 3))
    np.testing.assert_array_equal(
        tp._local_maxima(torch.from_numpy(smooth), radius).numpy(),
        np.asarray(jp._local_maxima(jnp.asarray(smooth), radius)))


PICK_CASES = {
    "default": dict(particle_radius_px=16, max_picks=64, threshold_sigma=2.0,
                    edge_px=16),
    "no_contamination": dict(particle_radius_px=16, max_picks=64,
                             threshold_sigma=2.0, edge_px=16,
                             mask_contamination=False),
    "few": dict(particle_radius_px=16, max_picks=8, threshold_sigma=1.0,
                edge_px=40, min_distance_px=24),
    "band": dict(particle_radius_px=12, max_picks=128, threshold_sigma=1.5,
                 band_low=5.0, band_high=1.2, disk_frac=0.4, cont_sigma=6.0,
                 cont_scale=3.0),
    "bright": dict(particle_radius_px=16, max_picks=64, threshold_sigma=2.0,
                   invert=False),
}


@pytest.mark.parametrize("case", sorted(PICK_CASES))
def test_pick_particles(mic, case):
    img = mic[0]
    kw = PICK_CASES[case]
    ref = jp.pick_particles(jnp.asarray(img), **kw)
    out = tp.pick_particles(img, device="cpu", **kw)
    assert out.coords.shape == (kw["max_picks"], 2)
    assert valid_set(out) == valid_set(ref)
    n = int(np.asarray(ref.valid).sum())
    assert int(out.valid.sum()) == n
    np.testing.assert_allclose(out.scores.numpy()[:n],
                               np.asarray(ref.scores)[:n], atol=1e-4)
    assert not out.valid[n:].any() and torch.isinf(out.scores[n:]).all()


def test_pick_orders_equal_scores_by_index():
    """A flat response: every candidate ties; the port lists them by
    rising index, as jax.lax.top_k does."""
    img = np.zeros((64, 64), np.float32)
    for y, x in ((20, 40), (20, 12), (44, 30)):
        img[y, x] = -1000.0
    kw = dict(particle_radius_px=4, max_picks=6, threshold_sigma=0.5,
              edge_px=4, mask_contamination=False)
    ref = jp.pick_particles(jnp.asarray(img), **kw)
    out = tp.pick_particles(img, device="cpu", **kw)
    n = int(np.asarray(ref.valid).sum())
    assert n >= 3
    np.testing.assert_array_equal(out.coords.numpy()[:n],
                                  np.asarray(ref.coords)[:n])


def test_pick_recovers_planted_particles(mic):
    img, coords = mic
    out = tp.pick_particles(img, particle_radius_px=16, max_picks=64,
                            threshold_sigma=2.0, edge_px=16, device="cpu")
    found = out.coords.numpy()[out.valid.numpy()]
    d = np.sqrt(((found[:, None] - coords[None]) ** 2).sum(-1))
    assert (d.min(axis=0) < 16).mean() >= 0.8
    assert (d.min(axis=1) < 16).mean() >= 0.8
    noise = np.random.RandomState(5).randn(256, 256).astype(np.float32)
    res = tp.pick_particles(noise, particle_radius_px=16, max_picks=64,
                            threshold_sigma=4.0, device="cpu")
    assert int(res.valid.sum()) < 5


def test_gold_beads_and_erase():
    img, coords = make_micrograph(n_particles=5, radius=6, contrast=-30.0)
    ref = jp.detect_gold_beads(jnp.asarray(img), bead_radius_px=6,
                               threshold_sigma=6.0)
    out = tp.detect_gold_beads(img, bead_radius_px=6, threshold_sigma=6.0,
                               device="cpu")
    assert valid_set(out) == valid_set(ref) and len(valid_set(out)) >= 4
    erased_ref = jp.erase_blobs(jnp.asarray(img), ref.coords, ref.valid, 9.0)
    erased = tp.erase_blobs(torch.from_numpy(img), out.coords, out.valid, 9.0)
    np.testing.assert_array_equal(erased.numpy(), np.asarray(erased_ref))
    for y, x in coords:
        assert abs(float(erased[y, x]) - float(np.median(img))) < 1e-6


@pytest.mark.parametrize("shape", [(3, 64, 80), (65, 63)])
def test_remove_hot_pixels(shape):
    rng = np.random.RandomState(7)
    x = rng.poisson(3.0, shape).astype(np.float32)
    flat = x.reshape(-1)
    hot = rng.choice(flat.size, 12, replace=False)
    flat[hot] += 500.0
    ref = jp.remove_hot_pixels(jnp.asarray(x), sigmas=6.0)
    out = tp.remove_hot_pixels(torch.from_numpy(x), sigmas=6.0)
    close(out, ref, rtol=1e-6, atol_rel=1e-6)
    # each hot pixel becomes its 3x3 mean (two may be neighbours)
    assert out.numpy().reshape(-1)[hot].max() < 2.5 * 503.0 / 9


def test_window_particles_clamps_to_the_image(mic):
    img = mic[0]
    coords = np.array([[0, 0], [5, 500], [511, 511], [256, 256], [300, 10]])
    ref = je.window_particles(jnp.asarray(img), jnp.asarray(coords), 64)
    out = te.window_particles(torch.from_numpy(img), coords, 64)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


EXTRACT_CASES = {
    "default": dict(),
    "subpixel": dict(subpixel=True),
    "downsample": dict(downsample_to=32),
    "subpixel_downsample": dict(subpixel=True, downsample_to=48),
    "raw": dict(normalize=False, invert=False),
    "no_normalize": dict(normalize=False),
}


@pytest.mark.parametrize("case", sorted(EXTRACT_CASES))
def test_extract_particles(mic, case):
    img, coords = mic
    kw = EXTRACT_CASES[case]
    c = coords.astype(np.float32)
    if kw.get("subpixel"):
        c = c + np.random.RandomState(1).uniform(-0.5, 0.5, c.shape).astype(np.float32)
    ref = je.extract_particles(jnp.asarray(img), jnp.asarray(c), 64, **kw)
    out = te.extract_particles(img, c, 64, device="cpu", **kw)
    assert out.dtype == torch.float32
    close(out, ref)


def test_extract_normalizes_the_background(mic):
    img, coords = mic
    out = te.extract_particles(img * 7.0 + 3.0, coords, 64, device="cpu").numpy()
    ax = np.arange(64) - 32
    bg = np.sqrt(ax[:, None] ** 2 + ax[None, :] ** 2) >= 0.375 * 64 + 2
    assert np.abs(out[:, bg].mean(axis=1)).max() < 0.05
    assert np.abs(out[:, bg].var(axis=1) - 1.0).max() < 0.05
    # planted blobs are dark; extraction inverts them
    assert out[:, 28:36, 28:36].mean() > 1.0


@pytest.mark.parametrize("shifts", ["none", "global", "per_particle"])
def test_extract_from_frames(mic, shifts):
    img, coords = mic
    rng = np.random.RandomState(2)
    frames = np.stack([np.roll(img, (i, -i), (0, 1)) for i in range(4)])
    sh = {"none": None,
          "global": rng.uniform(-3, 3, (4, 2)).astype(np.float32),
          "per_particle": rng.uniform(-3, 3, (len(coords), 4, 2)).astype(np.float32)}[shifts]
    ref = je.extract_from_frames(jnp.asarray(frames), jnp.asarray(coords), 48,
                                 shifts=None if sh is None else jnp.asarray(sh))
    out = te.extract_from_frames(frames, coords, 48, shifts=sh, device="cpu")
    assert out.shape == (len(coords), 4, 48, 48)
    close(out, ref)
