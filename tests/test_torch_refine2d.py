"""Parity of pyp_tpu_torch.ops.refine2d (2D classification) with
pyp_tpu.ops.refine2d on the CPU, at box 32 / 2 Å per pixel (the staged
protocol's Fourier crop at box 64), on the seeded class images of
tests/test_refine2d.py.

Tolerances:
  * _rotate_images: 1e-5 x max|image|, border pixels included;
  * the gather E-step (align_to_classes, the plain version of the
    shift_scored_match kernel): assignments, psi and shifts equal, scores
    within 1e-4. The data are tie-free; where two (class, shift) pairs tie
    exactly, JAX takes the first shift and then the first class, the port
    the first shift per class and then the first class;
  * the polar E-step and the M-step: 1e-5 x the reference's max|value|,
    indices equal;
  * classify2d (3 iterations, both engines), classify2d_staged and the
    classify2d mode: assignments equal, averages cc >= 0.999.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pyp_tpu.config.params import defaults
from pyp_tpu.core.filters import apply_bandpass, soft_circular_mask
from pyp_tpu.ops import refine2d as jr
from pyp_tpu.ops.fourier_slice import fourier_to_image, image_to_fourier
from pyp_tpu.ops.reconstruct import _ctf_grids, _shift_correct
from pyp_tpu_torch.ops import refine2d as tr
from pyp_tpu_torch.ops import refine3d as tr3

PIXEL = 2.0


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def class_images(n, n_classes, seed):
    rng = np.random.RandomState(seed)
    mask = np.asarray(soft_circular_mask(n, n * 0.35, 3.0))
    outs = []
    for _ in range(n_classes):
        img = rng.randn(n, n).astype(np.float32)
        img = np.array(apply_bandpass(jnp.asarray(img)[None], 0.0, 0.2)[0]) * mask
        outs.append(img * 10)
    return np.stack(outs)


def dataset(n=32, n_classes=2, per_class=12, noise=0.25, seed=6):
    """Rotated, shifted, CTF-modulated noisy copies of seeded class
    images (tests/test_refine2d.py's recipe): (stack, ctf, labels)."""
    classes = class_images(n, n_classes, seed - 1)
    rng = np.random.RandomState(seed)
    imgs, labels = [], []
    for k in range(n_classes):
        for _ in range(per_class):
            psi = rng.uniform(0, 360)
            sh = rng.uniform(-2, 2, 2).astype(np.float32)
            img = np.array(jr._rotate_images(jnp.asarray(classes[k])[None],
                                             jnp.asarray([psi]))[0])
            F = _shift_correct(image_to_fourier(jnp.asarray(img)[None]),
                               -jnp.asarray(sh)[None], n)
            imgs.append(np.array(fourier_to_image(F, n)[0]))
            labels.append(k)
    imgs = np.stack(imgs)
    imgs += noise * np.abs(imgs).max() * rng.randn(*imgs.shape).astype(np.float32)
    df = rng.uniform(12000, 20000, len(imgs)).astype(np.float32)
    ctf = np.stack([df, df + 300, rng.uniform(0, 180, len(df)),
                    np.zeros_like(df)], 1).astype(np.float32)
    grids = _ctf_grids(n, PIXEL, jnp.asarray(ctf), 300.0, 2.7, 0.07)
    imgs = np.array(fourier_to_image(image_to_fourier(jnp.asarray(imgs)) * grids, n))
    return imgs.astype(np.float32), ctf, np.array(labels)


@pytest.fixture(scope="module")
def data():
    return dataset()


def t(x):
    return torch.from_numpy(np.array(x))


def close(out, ref, rel=1e-5):
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=rel * float(np.abs(ref).max()))


def cc(a, b):
    return float(np.corrcoef(np.ravel(a), np.ravel(b))[0, 1])


def test_rotate_images_matches_jax_border_included():
    rng = np.random.RandomState(0)
    imgs = rng.randn(5, 32, 32).astype(np.float32)
    psi = np.array([0.0, 37.5, 90.0, -123.25, 200.0], np.float32)
    ref = np.asarray(jr._rotate_images(jnp.asarray(imgs), jnp.asarray(psi)))
    out = tr._rotate_images(t(imgs), t(psi))
    close(out, ref)
    # the corners rotate out of the box: zero there in both
    assert ref[2, 0, 0] == 0.0 and out[2, 0, 0] == 0.0


def _gather_inputs(stack, n):
    avgs = class_images(n, 2, 5)
    psis = np.arange(0.0, 360.0, 20.0, dtype=np.float32)
    pts = tr3.make_mask_points(n, PIXEL, 100.0, 3.0 * PIXEL)
    grid = tr3.make_shift_grid(3.0, 1.0)
    return avgs, psis, pts, grid


def test_align_to_classes_gather_matches_jax(data):
    stack, ctf, _ = data
    n = stack.shape[-1]
    avgs, psis, pts, grid = _gather_inputs(stack, n)
    ref = jr.align_to_classes(jnp.asarray(stack), jnp.asarray(ctf),
                              jnp.asarray(avgs), jnp.asarray(psis), pts, grid,
                              n, PIXEL)
    out = tr.align_to_classes(t(stack), t(ctf), t(avgs), t(psis), t(pts),
                              t(grid), n, PIXEL)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(out[2].numpy(), np.asarray(ref[2]), atol=1e-5)
    np.testing.assert_allclose(out[3].numpy(), np.asarray(ref[3]), atol=1e-4)


def test_polar_estep_and_mstep_match_jax(data):
    stack, ctf, _ = data
    n = stack.shape[-1]
    avgs = class_images(n, 2, 5)
    key = (n, PIXEL, 100.0, 3.0 * PIXEL, 3.0, 1.0, 300.0, 2.7, 0.07)
    jp = jr.Polar2D.get(*key)
    tp = tr.Polar2D.get(*key, device="cpu")
    jXp, jwr = jp.restore(jnp.asarray(stack), jnp.asarray(ctf))
    tXp, twr = tp.restore(stack, ctf)
    close(tXp, jXp)
    close(twr, jwr)
    ref = jr.align_to_classes_polar(jXp, jwr, jnp.asarray(avgs), jp)
    out = tr.align_to_classes_polar(tXp, twr, t(avgs), tp)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    close(out[2], ref[2])
    close(out[3], ref[3])
    # the M-step at the E-step's alignment
    kw = dict(n=n, n_classes=2, pixel_size=PIXEL)
    w = np.linspace(0.5, 1.0, len(stack)).astype(np.float32)
    ja, jo = jr.update_class_averages(
        jnp.asarray(stack), jnp.asarray(ctf), ref[0], ref[1], ref[2],
        jnp.asarray(w), **kw)
    ta, to = tr.update_class_averages(
        t(stack), t(ctf), t(np.asarray(ref[0])), t(np.asarray(ref[1])),
        t(np.asarray(ref[2])), t(w), **kw)
    close(ta, ja)
    close(to, jo)
    assert tr.Polar2D.get(*key, device="cpu") is tp


@pytest.mark.parametrize("engine", ["polar", "gather"])
def test_classify2d_matches_jax(data, engine):
    stack, ctf, labels = data
    kw = dict(iters=3, psi_step=20.0, high_res=3.0 * PIXEL, shift_extent=3.0,
              shift_step=1.0, seed=4, engine=engine)
    ref = jr.classify2d(jnp.asarray(stack), jnp.asarray(ctf), 2, PIXEL, **kw)
    out = tr.classify2d(stack, ctf, 2, PIXEL, device="cpu", **kw)
    np.testing.assert_array_equal(out.assignments.numpy(),
                                  np.asarray(ref.assignments))
    for k in range(2):
        assert cc(out.class_avgs[k].numpy(), ref.class_avgs[k]) >= 0.999
    np.testing.assert_allclose(out.occupancy.numpy(), np.asarray(ref.occupancy))
    # and the classes are found: purity 1 on this easy set
    a = out.assignments.numpy()
    assert max((a == labels).mean(), (a != labels).mean()) == 1.0


def test_classify2d_staged_with_bin_and_radius_matches_jax():
    """Box 64 binned to 32, masked; every phase in one band and on the
    gather engine (each distinct JAX shape costs a compile); the last
    phase sees 8 of 12 particles, so the final full-set E-step runs."""
    stack, ctf, _ = dataset(n=64, per_class=6, seed=8)
    params = defaults()
    params.update({
        "class_num": 2, "class_rhcls": 4.0 * PIXEL, "class_psi_step": 30.0,
        "class2d_rhini": 4.0 * PIXEL, "class_engine": "gather",
        "class_shift": 3.0, "class_shift_step": 1.5,
        "class2d_bin": 2, "class2d_rad": 64 * PIXEL * 0.4,
        "class2d_iters_init": 2, "class2d_iters_seed": 1,
        "class2d_iters_refine": 1, "class2d_max_ab_initio": 8,
        "class2d_max_refinement": 8, "class_seed": 4,
    })
    ref = jr.classify2d_staged(stack, ctf, params, PIXEL)
    out = tr.classify2d_staged(stack, ctf, params, PIXEL, device="cpu")
    assert out.class_avgs.shape == (2, 32, 32)
    assert len(out.assignments) == len(stack)
    np.testing.assert_array_equal(out.assignments.numpy(),
                                  np.asarray(ref.assignments))
    for k in range(2):
        assert cc(out.class_avgs[k].numpy(), ref.class_avgs[k]) >= 0.999


def test_classify2d_mode_matches_jax(data, tmp_path, monkeypatch):
    from pyp_tpu import cli as jcli
    from pyp_tpu.io import cistem as jcistem
    from pyp_tpu.io import mrc as jmrc
    from pyp_tpu_torch import cli as tcli

    stack, ctf, _ = data
    argv = ["classify2d", "-class_num", "2", "-class_2d_iters", "2",
            "-class_rhcls", "6", "-class_psi_step", "20", "-class_shift", "3",
            "-class_shift_step", "1", "-class_seed", "4", "-scope_pixel", "2"]
    outs = {}
    for name, main in (("jax", jcli.main),
                       ("port", lambda a: tcli.main(a, device="cpu"))):
        d = tmp_path / name
        d.mkdir()
        table = jcistem.Table.zeros(len(stack))
        table["position_in_stack"] = np.arange(1, len(stack) + 1)
        table["defocus_1"], table["defocus_2"] = ctf[:, 0], ctf[:, 1]
        table["defocus_angle"] = ctf[:, 2]
        jmrc.write(stack, d / "stack.mrc", pixel_size=PIXEL)
        jcistem.write_parameters(table, d / "stack.cistem")
        monkeypatch.chdir(d)
        assert main(argv) == 0
        outs[name] = (jmrc.read(d / "classes_2d.mrc"),
                      jcistem.read_parameters(d / "stack.cistem"))
    (ja, jt), (ta, tt) = outs["jax"], outs["port"]
    np.testing.assert_array_equal(tt["best_2d_class"], jt["best_2d_class"])
    assert ta.shape == ja.shape == (2, 32, 32)
    for k in range(2):
        assert cc(ta[k], ja[k]) >= 0.999
