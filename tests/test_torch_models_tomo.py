"""Parity of pyp_tpu_torch/models/membrane.py and miner.py with the JAX
package on the CPU: the procedural membrane batches, the segmenter's
training from carried weights, slice-batched segmentation with reflect
padding at odd sizes, virion seeds from a probability map; the 3D
encoder, the miner's augmentations, normalization and grid, contrastive
training (NT-Xent) from carried weights, embeddings, k-means and the
dense mining sweep.

Tolerances: numpy draws (synthetic batches, augmentations, grids,
k-means) equal; trained kernels and the encoder's embeddings 1e-4 x max
after three Adam steps (1e-5 with carried weights alone); probability
volumes 1e-5; virion seeds and mining clusters equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyp_tpu.models import membrane as jmem
from pyp_tpu.models import miner as jmin
from pyp_tpu_torch.models import io as tio
from pyp_tpu_torch.models import membrane as tmem
from pyp_tpu_torch.models import miner as tmin
from tests.test_torch_models import (_two_threads, carried_init, close,
                                     np_tree, unet_init)

assert _two_threads   # the module fixture shared with test_torch_models
CPU = "cpu"
FEATS = (4, 8)


# ---------------------------------------------------------------- membrane

def test_synth_batch_is_exact():
    for n in (24, 33):
        jx, jy = jmem._synth_batch(np.random.RandomState(1), 3, n)
        tx, ty = tmem._synth_batch(np.random.RandomState(1), 3, n)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)


@pytest.fixture(scope="module")
def segmenters():
    kw = dict(steps=3, batch=2, patch=24, features=FEATS)
    jm = jmem.train_membrane_segmenter(**kw)
    with carried_init(UNet2D=unet_init(FEATS)):
        tm = tmem.train_membrane_segmenter(device=CPU, **kw)
    return jm, tm


def test_train_membrane_segmenter_three_steps(segmenters):
    jm, tm = segmenters
    assert tm.features == jm.features == FEATS
    for k, v in tio.from_flax(np_tree(jm.params)).items():
        if k.endswith("kernel"):
            close(tm.params[k], v.numpy(), rel=1e-4)


@pytest.mark.parametrize("shape", [(5, 30, 34), (3, 29, 33)])
def test_segment_tomogram_with_reflect_padding(segmenters, shape):
    jm, _ = segmenters
    carried = tmem.MembraneModel(tio.from_flax(np_tree(jm.params)), FEATS)
    vol = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    want = jmem.segment_tomogram(jm, vol, batch=2)
    for batch in (None, 2):
        got = tmem.segment_tomogram(carried, vol, batch=batch, device=CPU)
        close(got, want)


def test_detect_virions_from_segmentation():
    n = 28
    ax = np.arange(n) - 13.5
    r = np.sqrt(ax[:, None, None] ** 2 + ax[None, :, None] ** 2
                + (ax[None, None, :] - 2) ** 2)
    prob = np.exp(-0.5 * ((r - 7.0) / 1.2) ** 2)
    # noise breaks the shell score's symmetric ties
    prob = (prob + 0.1 * np.random.RandomState(4).rand(n, n, n)).astype(
        np.float32)
    want = jmem.detect_virions_from_segmentation(prob, [6.0, 7.0, 8.0], 3)
    got = tmem.detect_virions_from_segmentation(prob, [6.0, 7.0, 8.0], 3,
                                                device=CPU)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    ok = np.asarray(want[3])
    np.testing.assert_array_equal(got[0].numpy()[ok], np.asarray(want[0])[ok])
    np.testing.assert_allclose(got[1].numpy()[ok], np.asarray(want[1])[ok])
    close(got[2][torch.as_tensor(ok)], np.asarray(want[2])[ok], rel=1e-4)


# ---------------------------------------------------------------- miner

def encoder_init(seed=0, embed_dim=6):
    return jax.jit(jmin.Encoder3D(embed_dim=embed_dim).init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8, 8, 8, 1)))


def test_augment_normalize_and_grid_are_exact():
    rng = np.random.RandomState(2)
    p = rng.randn(5, 6, 6, 6).astype(np.float32)
    np.testing.assert_array_equal(
        tmin._augment(p, np.random.RandomState(4)),
        jmin._augment(p, np.random.RandomState(4)))
    np.testing.assert_array_equal(tmin._normalize(p), jmin._normalize(p))
    vol = rng.randn(14, 19, 17).astype(np.float32)
    for a, b in zip(tmin.sample_grid_patches(vol, 6, 4),
                    jmin.sample_grid_patches(vol, 6, 4)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_encoder3d_forward_with_carried_weights():
    p = encoder_init(1)
    x = np.random.RandomState(3).randn(3, 9, 8, 10, 1).astype(np.float32)
    want = jax.jit(jmin.Encoder3D(embed_dim=6).apply)(p, jnp.asarray(x))
    enc = tmin.Encoder3D(embed_dim=6)
    enc.load_state_dict(tio.from_flax(np_tree(p)))
    got = enc(torch.as_tensor(np.moveaxis(x, -1, 1).copy()))
    close(got, np.asarray(want))


@pytest.fixture(scope="module")
def tomograms():
    rng = np.random.RandomState(5)
    return [rng.randn(16, 20, 18).astype(np.float32),
            rng.randn(12, 16, 16).astype(np.float32)]


@pytest.fixture(scope="module")
def miners(tomograms):
    kw = dict(patch=8, n_steps=3, batch=4, embed_dim=6)
    jm = jmin.train_miner(tomograms, **kw)
    with carried_init(Encoder3D=encoder_init(0)):
        tm = tmin.train_miner(tomograms, device=CPU, **kw)
    return jm, tm


def test_train_miner_three_steps(miners, tomograms):
    jm, tm = miners
    assert (tm.patch, tm.embed_dim) == (jm.patch, jm.embed_dim) == (8, 6)
    for k, v in tio.from_flax(np_tree(jm.params)).items():
        if k.endswith("kernel"):
            close(tm.params[k], v.numpy(), rel=1e-4)
    wins, _ = jmin.sample_grid_patches(tomograms[0], 8, 4)
    close(tmin.embed_patches(tm, wins, device=CPU),
          jmin.embed_patches(jm, wins, batch=16), rel=1e-4)


def test_kmeans_is_exact():
    z = np.random.RandomState(6).randn(40, 5).astype(np.float32)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    for a, b in zip(tmin.kmeans(z, 4, seed=3), jmin.kmeans(z, 4, seed=3)):
        np.testing.assert_array_equal(a, b)


def test_mine_tomogram_with_carried_weights(miners, tomograms):
    jm, _ = miners
    carried = tmin.MinerModel(tio.from_flax(np_tree(jm.params)), 8, 6)
    vol = tomograms[0]
    jc, jl, jco = jmin.mine_tomogram(jm, vol, n_clusters=3)
    tc, tl, tco = tmin.mine_tomogram(carried, vol, n_clusters=3, device=CPU)
    np.testing.assert_array_equal(tco, jco)
    # the embeddings agree to float tolerance; the clusters they give too
    wins, _ = jmin.sample_grid_patches(vol, 8, 4)
    close(tmin.embed_patches(carried, wins, device=CPU),
          jmin.embed_patches(jm, wins), rel=1e-5)
    np.testing.assert_array_equal(tl, jl)
    for a, b in zip(tc, jc):
        assert a["size"] == b["size"]
        np.testing.assert_array_equal(a["coords"], b["coords"])
        np.testing.assert_array_equal(a["exemplars"], b["exemplars"])
