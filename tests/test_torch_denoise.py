"""Parity of pyp_tpu_torch/models/denoise.py with the JAX package on the
CPU: noise2noise training (with and without the cosine schedule) for
three Adam steps from carried weights, the tiled image and tomogram
denoisers, the wedge filters and mask, the wedge restorer's training and
its application.

Tolerances: trained kernels 1e-4 x max (a conv bias in front of a
GroupNorm has only float noise for a gradient, which Adam's first steps
scale to +-lr, so biases are held through the outputs); denoised images
and restored volumes 1e-4 x max; the wedge filters 1e-5 x max and the
mask equal; the restorer's last loss 1e-4 relative; learning rates of
the cosine schedule 1e-6 relative.
"""

import jax
import numpy as np
import optax
import pytest

from pyp_tpu.models import denoise as jden
from pyp_tpu_torch.models import denoise as tden
from pyp_tpu_torch.models import io as tio
from tests.test_torch_models import (FEATS, _two_threads, carried_init,
                                     close, np_tree, unet_init)

assert _two_threads   # the module fixture shared with that file
CPU = "cpu"


def test_cosine_schedule_matches_optax():
    for lr, steps, fin in ((1e-3, 7, 1e-5), (3e-4, 60, 1e-4), (1e-3, 1, 1e-6)):
        sched = optax.cosine_decay_schedule(lr, steps, alpha=fin / lr)
        for count in range(steps + 2):
            np.testing.assert_allclose(
                tden._cosine_decay(lr, steps, fin / lr, count),
                float(sched(count)), rtol=1e-6)


@pytest.fixture(scope="module")
def noisy_pairs():
    rng = np.random.RandomState(8)
    sig = rng.randn(3, 40, 36).astype(np.float32)
    a = sig + 0.5 * rng.randn(*sig.shape).astype(np.float32)
    b = sig + 0.5 * rng.randn(*sig.shape).astype(np.float32)
    return a, b


@pytest.mark.parametrize("lr_finish", [0.0, 1e-5])
def test_train_denoiser_three_steps(noisy_pairs, lr_finish):
    a, b = noisy_pairs
    kw = dict(patch=16, steps=3, batch=4, lr=1e-3, features=FEATS,
              lr_finish=lr_finish)
    jm = jden.train_denoiser([a[:2], a[2]], [b[:2], b[2]], **kw)
    with carried_init(UNet2D=unet_init(FEATS)):
        tm = tden.train_denoiser([a[:2], a[2]], [b[:2], b[2]], device=CPU,
                                 **kw)
    for k, v in tio.from_flax(np_tree(jm.params)).items():
        if k.endswith("kernel"):
            close(tm.params[k], v.numpy(), rel=1e-4)
    want = jden.denoise_image(jm, a[0], features=FEATS)
    got = tden.denoise_image(tm, a[0], features=FEATS, device=CPU)
    close(got, want, rel=1e-4)


def test_denoise_image_and_tomogram_with_carried_weights(noisy_pairs):
    a, _ = noisy_pairs
    p = unet_init((16, 32, 64), seed=2)
    jm = jden.DenoiseModel(params=p, patch=16)
    tm = tden.DenoiseModel(params=tio.from_flax(np_tree(p)), patch=16)
    img = a[0][:36, :28] * 3 + 2            # a scale and an offset kept
    close(tden.denoise_image(tm, img, features=(16, 32, 64), device=CPU),
          jden.denoise_image(jm, img, features=(16, 32, 64)), rel=1e-4)
    vol = a[:2, :24, :32]
    close(tden.denoise_tomogram(tm, vol, device=CPU),
          jden.denoise_tomogram(jm, vol), rel=1e-4)


def test_wedge_filters_and_mask():
    rng = np.random.RandomState(9)
    img = rng.randn(20, 18).astype(np.float32)
    vol = rng.randn(12, 5, 14).astype(np.float32)
    for tilt in (50.0, 60.0):
        close(tden.wedge_filter_2d(img, tilt, device=CPU),
              jden.wedge_filter_2d(img, tilt), rel=1e-5)
        close(tden.wedge_filter_3d(vol, tilt, device=CPU),
              jden.wedge_filter_3d(vol, tilt), rel=1e-5)
        for shape in ((16, 16), (15, 22)):
            np.testing.assert_array_equal(
                tden._wedge_mask(shape, tilt, device=CPU).numpy(),
                np.asarray(jden._wedge_mask(shape, tilt)))


@pytest.fixture(scope="module")
def wedge_pair():
    rng = np.random.RandomState(10)
    vols = [np.asarray(jden.wedge_filter_3d(v, 50.0))
            for v in rng.randn(2, 16, 8, 16).astype(np.float32)]
    kw = dict(patch=16, steps=3, batch=4, features=FEATS)
    jm = jden.train_wedge_restorer(vols, 50.0, **kw)
    with carried_init(UNet2D=unet_init(FEATS)):
        tm = tden.train_wedge_restorer(vols, 50.0, device=CPU, **kw)
    return vols, jm, tm


def test_train_wedge_restorer_three_steps(wedge_pair):
    _, jm, tm = wedge_pair
    assert tm.params["tilt_max"] == jm.params["tilt_max"] == 50.0
    np.testing.assert_allclose(tm.params["final_loss"],
                               jm.params["final_loss"], rtol=1e-4)
    for k, v in tio.from_flax(np_tree(jm.params["net"])).items():
        if k.endswith("kernel"):
            close(tm.params["net"][k], v.numpy(), rel=1e-4)


def test_restore_wedge_keeps_the_measured_sector(wedge_pair):
    vols, jm, tm = wedge_pair
    want = jden.restore_wedge(jm, vols[1], features=FEATS)
    carried = tden.DenoiseModel(
        params=dict(jm.params, net=tio.from_flax(np_tree(jm.params["net"]))),
        patch=16)
    got = tden.restore_wedge(carried, vols[1], features=FEATS, device=CPU)
    close(got, want, rel=1e-4)
    measured = ~tden._wedge_mask((16, 16), 50.0, device=CPU).numpy()
    F_in = np.fft.rfft2(vols[1][:, 3, :])
    F_out = np.fft.rfft2(got.numpy()[:, 3, :])
    np.testing.assert_allclose(F_out[measured], F_in[measured], atol=1e-3)
