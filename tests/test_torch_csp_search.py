"""Parity of the CSP searches and schedules of pyp_tpu_torch/ops/csp.py
with the JAX package on the CPU: the candidate grids (exact), the grid
search of each mode (the same winner per tilt or particle, and the first
of tied candidates, as `jnp.argmax` takes it), the fused mode schedule
with and without the optimizer's termination tolerances, and the series
batch, sequential against vectorized. The series is the JAX tests' own
(`tests/test_csp.make_tilt_series`: 7 tilts, 6 particles, box 24).

Tolerances: candidate grids equal; the grid searches' parameters within
1e-5 (the winners are the same candidates) and best scores within 1e-5;
the schedules (3 steps a mode, two modes) parameters within 1e-3 of their
scale and scores within 1e-5; the port's sequential and vectorized batch
within 1e-5 of each other (the same float32 operations on stacked rows).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyp_tpu.ops import csp as jcsp
from pyp_tpu.ops import fourier_slice as jfs
from pyp_tpu.ops.refine3d import make_mask_points
from pyp_tpu_torch.ops import csp as tcsp
from pyp_tpu_torch.ops import fourier_slice as tfs
from tests.test_csp import NBOX, PIXEL, P, T, make_reference, make_tilt_series

KW = dict(voltage_kv=300.0, cs_mm=2.7, amplitude_contrast=0.07)
STATIC = ("mode", "n", "pixel_size", "voltage_kv", "cs_mm",
          "amplitude_contrast")
GRIDS = {0: (2.0, 1.0), 1: (6.0, 6.0, 6.0), 2: 1.5, 3: 1.5, 4: 400.0}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.as_tensor(np.array(x))


def to_port(p):
    return tcsp.CspParams(*(t(x) for x in p))


def assert_params(pt, pj, atol):
    for a, b in zip(pt, pj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=atol)


@pytest.fixture(scope="module")
def setup():
    vol = make_reference()
    true, images, defocus = make_tilt_series(vol)
    rng = np.random.RandomState(11)
    start = true._replace(
        tilt_shifts=true.tilt_shifts + rng.uniform(-1.5, 1.5, (T, 2)).astype(np.float32),
        particle_eulers=true.particle_eulers + rng.uniform(-5, 5, (P, 3)).astype(np.float32),
        particle_pos=true.particle_pos + rng.uniform(-1, 1, (P, 3)).astype(np.float32))
    mask = np.asarray(make_mask_points(NBOX, PIXEL, 60.0, 2.5 * PIXEL))
    xv, wc, va = jcsp.prepare_series_windows(images, start, NBOX,
                                             jnp.asarray(mask))
    va = np.array(va)
    va[2, :] = 0.0        # a tilt no particle is seen in
    va[:, 4] = 0.0        # a particle seen in no tilt
    ja = (start, xv, jnp.asarray(wc), defocus, jnp.asarray(mask),
          jfs.volume_to_fourier(jnp.asarray(vol)), jnp.ones(T),
          jnp.asarray(va))
    pa = (to_port(start), t(xv), t(wc), t(defocus), t(mask),
          tfs.volume_to_fourier(t(vol)), torch.ones(T), t(va))
    return dict(true=true, ja=ja, pa=pa, images=np.asarray(images),
                mask=mask, vol=vol, defocus=np.asarray(defocus))


@pytest.mark.parametrize("cfg", [
    dict(modes=(3, 0, 2, 1), grid_tols={3: 10.0, 0: (2.0, 0.0), 2: 10.0,
                                        1: (10.0, 10.0, 10.0)}),
    dict(modes=(0, 4, 1, 7, 5, 6), grid_tols={0: (3.0, 2.0), 4: 2000.0,
                                              1: (5.0, 8.0, 9.0), 7: 4.0,
                                              5: 3.0, 6: 2.0},
         grid_steps=5, spin_step=30.0, random_iters=7),
    dict(modes=(1, 2, 3), grid_tols={1: 12.0, 2: 3.0, 3: 0.0},
         angle_step=4.0, shift_step=1.0),
    dict(modes=(3, 1), grid_tols=None),
])
def test_build_mode_offsets_is_exact(cfg):
    args = dict(cfg)
    modes, tols = args.pop("modes"), args.pop("grid_tols")
    steps = args.pop("grid_steps", 9)
    spin = args.pop("spin_step", 0.0)
    oj, sj = jcsp.build_mode_offsets(modes, tols, steps, spin, **args)
    ot, st = tcsp.build_mode_offsets(modes, tols, steps, spin, **args)
    assert len(ot) == len(oj)
    for a, b in zip(ot, oj):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, np.asarray(b))
    assert (st is None) == (sj is None)
    if st is not None:
        np.testing.assert_array_equal(st, np.asarray(sj))


@pytest.mark.parametrize("mode", sorted(GRIDS))
def test_grid_search_picks_the_same_candidates(setup, mode):
    offsets = jcsp.make_mode_offsets(mode, GRIDS[mode], 5)
    jfn = jax.jit(jcsp._grid_search_xv, static_argnames=STATIC)
    ja = setup["ja"]
    pj, sj = jfn(*ja, jnp.asarray(offsets), mode=mode, n=NBOX,
                 pixel_size=PIXEL, **KW)
    pt, st = tcsp._grid_search_xv(*setup["pa"], offsets, mode, NBOX, PIXEL,
                                  **KW)
    assert_params(pt, pj, 1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-5)
    # the unseen tilt (or particle) scores every candidate 0: a tie, which
    # goes to the first candidate
    field = tcsp.MODE_BLOCKS[mode][0]
    k = 2 if tcsp.MODE_AXIS[mode] == "tilt" else 4
    start = getattr(setup["pa"][0], field)[k]
    np.testing.assert_allclose(getattr(pt, field)[k].numpy() - start.numpy(),
                               offsets[0][:np.size(start.numpy()) or 1]
                               .reshape(np.shape(start.numpy())), atol=1e-5)


@pytest.mark.parametrize("tols", [(0.0, 0.0), (1e-3, 2e-3)],
                         ids=["plain", "tolerances"])
def test_fused_schedule_matches(setup, tols):
    """A grid search, the spin ring and two modes of 3 steps, with and
    without the termination tolerances (chosen so that series freeze in
    the middle of the steps)."""
    step_tol, value_tol = tols
    offs, spin = jcsp.build_mode_offsets((3, 1), {3: 1.0}, 3, 120.0)
    static = ("modes", "n", "pixel_size", "iters_per_mode", "voltage_kv",
              "cs_mm", "amplitude_contrast", "step_tol", "value_tol")
    pj, mj, sj = jax.jit(jcsp.csp_refine_schedule, static_argnames=static)(
        *setup["ja"], offs, spin, modes=(3, 1), n=NBOX, pixel_size=PIXEL,
        iters_per_mode=3, step_tol=step_tol, value_tol=value_tol, **KW)
    offs_t, spin_t = tcsp.build_mode_offsets((3, 1), {3: 1.0}, 3, 120.0)
    pt, mt, st = tcsp.csp_refine_schedule(
        *setup["pa"], offs_t, spin_t, (3, 1), NBOX, PIXEL, iters_per_mode=3,
        step_tol=step_tol, value_tol=value_tol, **KW)
    assert_params(pt, pj, 1e-3)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-5)


def test_series_batch_sequential_equals_vectorized_and_jax(setup):
    """Three series of different start errors: each step's gradient norm,
    momentum, termination and final keep-or-revert are per series, so the
    vectorized batch equals the sequential one (a batch that normalized
    one gradient over the summed losses would not), and both equal JAX's
    batch."""
    true, images, mask = setup["true"], setup["images"], setup["mask"]
    series = []
    for s, amp in enumerate((0.5, 1.5, 3.0)):
        rng = np.random.RandomState(20 + s)
        p = true._replace(
            tilt_shifts=true.tilt_shifts + rng.uniform(-amp, amp, (T, 2)).astype(np.float32),
            particle_eulers=true.particle_eulers + rng.uniform(-2 * amp, 2 * amp, (P, 3)).astype(np.float32))
        xv, wc, va = jcsp.prepare_series_windows(images, p, NBOX,
                                                 jnp.asarray(mask))
        series.append((p, xv, wc, va))
    stack = lambda i: np.stack([np.asarray(x[i]) for x in series])  # noqa: E731
    pb = jcsp.CspParams(*(np.stack([np.asarray(getattr(x[0], f)) for x in series])
                          for f in jcsp.CspParams._fields))
    xv_b, wc_b, va_b = stack(1), stack(2), stack(3)
    df_b = np.stack([setup["defocus"]] * 3)
    tw_b = np.ones((3, T), np.float32)
    offs, spin = jcsp.build_mode_offsets((3, 1), {3: 1.0}, 3)
    kw = dict(iters_per_mode=3, value_tol=1e-3, **KW)
    pj, mj, sj = jcsp.csp_refine_batch(
        jcsp.CspParams(*(jnp.asarray(x) for x in pb)), jnp.asarray(xv_b),
        jnp.asarray(wc_b), jnp.asarray(df_b), jnp.asarray(mask),
        setup["ja"][5], jnp.asarray(tw_b), jnp.asarray(va_b), offs, spin,
        (3, 1), NBOX, PIXEL, series_per_dispatch=2, **kw)
    args = (to_port(pb), t(xv_b), t(wc_b), t(df_b), t(mask), setup["pa"][5],
            t(tw_b), t(va_b), offs, spin, (3, 1), NBOX, PIXEL)
    seq = tcsp.csp_refine_batch(*args, series_vmap=False, **kw)
    vec = tcsp.csp_refine_batch(*args, series_vmap=True, **kw)
    assert_params(vec[0], [x.numpy() for x in seq[0]], 1e-5)
    for a, b in zip(vec[1:], seq[1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)
    assert_params(vec[0], pj, 1e-3)
    np.testing.assert_allclose(vec[1].numpy(), np.asarray(mj), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(vec[2].numpy(), np.asarray(sj), rtol=0,
                               atol=1e-5)


def test_csp_refine_entry_matches(setup):
    """csp_refine (windows cut on the device, the schedule, the particle
    scores) against the JAX entry point."""
    start = setup["ja"][0]
    kw = dict(modes=(3, 2), iters_per_mode=2, high_res=2.5 * PIXEL,
              grid_tols={2: 1.0}, grid_steps=3, return_particle_scores=True)
    pj, sj, psj = jcsp.csp_refine(start, setup["images"], setup["defocus"],
                                  setup["vol"], PIXEL, NBOX, **kw)
    pt, st, pst = tcsp.csp_refine(
        tcsp.make_params(*(np.asarray(x) for x in start), device="cpu"),
        setup["images"], setup["defocus"], setup["vol"], PIXEL, NBOX,
        device="cpu", **kw)
    assert_params(pt, pj, 1e-3)
    np.testing.assert_allclose(st, sj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(pst, psj, rtol=0, atol=1e-5)
