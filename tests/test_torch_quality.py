"""Parity of pyp_tpu_torch/models/quality.py with the JAX package on the
CPU: the 2-channel features, the autoencoder (with its crop at odd
sizes) on carried weights, the optimizers against optax's on the same
gradients (Adam, SGD + momentum, and add_decayed_weights chained in
front), training from carried weights (SGD + momentum step by step,
Adam by the loss it reaches), the embeddings and the quality scores. The micrographs are tests/test_quality.py's.

Tolerances: features 1e-4 x max (float32 FFTs in another order, the log
power spectrum's dynamic range); forwards with carried weights 1e-5;
optimizer steps 1e-6; after three SGD steps weights 1e-4 x max,
embeddings and scores 1e-3 x max (the scores are whitened by a
per-dimension spread of a few samples); Adam's reached loss within 5%.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyp_tpu.models import quality as jq
from pyp_tpu_torch.models import io as tio
from pyp_tpu_torch.models import quality as tq
from tests.test_quality import make_micrograph, smear
from tests.test_torch_models import _two_threads, carried_init, close, np_tree

assert _two_threads   # the module fixture shared with test_torch_models
CPU = "cpu"


@pytest.fixture(scope="module")
def mics():
    rng = np.random.RandomState(0)
    good = [make_micrograph(rng, "good") for _ in range(5)]
    bad = [make_micrograph(rng, "blank"), smear(make_micrograph(rng, "good"))]
    return np.stack(good + bad)[:, :100, :120]


def test_featurize(mics):
    for size in (32, 25):
        want = np.asarray(jq.featurize(mics, size))
        got = tq.featurize(mics, size, device=CPU)
        close(np.moveaxis(got.numpy(), 1, -1), want, rel=1e-4)


@functools.lru_cache(maxsize=None)
def ae_init(latent, size, seed=0):
    return jax.jit(jq.QualityAE(latent_dim=latent).init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 2)))


@pytest.mark.parametrize("size", [16, 13])
def test_autoencoder_crops_to_odd_sizes(size):
    p = ae_init(4, size, seed=3)
    x = np.random.RandomState(size).randn(3, size, size, 2).astype(np.float32)
    jz, jrec = jax.jit(jq.QualityAE(latent_dim=4).apply)(p, jnp.asarray(x))
    ae = tq.QualityAE(latent_dim=4, size=size)
    ae.load_state_dict(tio.from_flax(np_tree(p)))
    tz, trec = ae(torch.as_tensor(np.moveaxis(x, -1, 1).copy()))
    assert trec.shape == (3, 2, size, size)
    close(tz, np.asarray(jz))
    close(np.moveaxis(trec.detach().numpy(), 1, -1), np.asarray(jrec))


@pytest.mark.parametrize("name", ["adam", "adam_decay", "sgd_momentum",
                                  "sgd_momentum_decay"])
def test_optimizers_match_optax(name):
    """Each optimizer train_quality builds, against the optax chain the
    JAX package builds, on the same gradient sequence: Adam (eps outside
    the square root), SGD with momentum (dampening 0), and the decayed
    weights added to the gradient in front (torch's coupled
    weight_decay, not AdamW)."""
    import optax

    rng = np.random.RandomState(1)
    p0 = rng.randn(6, 3).astype(np.float32)
    grads = [rng.randn(6, 3).astype(np.float32) for _ in range(5)]
    lr, wd = 1e-2, (0.05 if name.endswith("decay") else 0.0)
    tx = optax.adam(lr) if name.startswith("adam") else optax.sgd(
        lr, momentum=0.9)
    if wd:
        tx = optax.chain(optax.add_decayed_weights(wd), tx)
    p, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    w = torch.nn.Parameter(torch.as_tensor(p0.copy()))
    opt = (torch.optim.Adam([w], lr=lr, weight_decay=wd)
           if name.startswith("adam") else
           torch.optim.SGD([w], lr=lr, momentum=0.9, weight_decay=wd))
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, p)
        p = optax.apply_updates(p, upd)
        w.grad = torch.as_tensor(g)
        opt.step()
    close(w.detach(), np.asarray(p), rel=1e-6)


def _trained(mics, opt, steps):
    kw = dict(size=24, latent_dim=4, steps=steps, batch=4, lr=1e-2)
    if opt == "sgd_momentum":
        kw.update(momentum=0.9)
    jm = jq.train_quality(mics, **kw)
    with carried_init(QualityAE=ae_init(4, 24)):
        tm = tq.train_quality(mics, device=CPU, **kw)
    return jm, tm


def test_train_quality_sgd_momentum_three_steps(mics):
    jm, tm = _trained(mics, "sgd_momentum", 3)
    for k, v in tio.from_flax(np_tree(jm.params)).items():
        if k.endswith("kernel"):
            close(tm.params[k], v.numpy(), rel=1e-4)
        else:   # biases of ~1e-4: float noise of the gradient's sum
            np.testing.assert_allclose(tm.params[k], v.numpy(), atol=1e-6)
    close(tm.mu, jm.mu, rel=1e-3)
    close(tm.sigma, jm.sigma, rel=1e-3)
    close(tq.embed_quality(tm, mics, device=CPU), jq.embed_quality(jm, mics),
          rel=1e-3)
    close(tq.quality_scores(tm, mics, device=CPU),
          jq.quality_scores(jm, mics), rel=1e-3)


def test_train_quality_adam_reaches_the_same_loss(mics):
    """Adam by what it reaches: the features are standardized, so the
    output biases' gradients cancel to float noise, which Adam's first
    steps scale to +-lr; the two runs then differ step by step, but reach
    the same reconstruction loss (within 5%)."""
    jm, tm = _trained(mics, "adam", 40)
    feats = tq.featurize(mics, 24, device=CPU)
    losses = []
    for params in (tio.from_flax(np_tree(jm.params)), tm.params):
        ae = tq.QualityAE(4, 24)
        ae.load_state_dict(params)
        with torch.no_grad():
            losses.append(float(torch.mean((ae(feats)[1] - feats) ** 2)))
    assert losses[1] < 0.9 and abs(losses[1] / losses[0] - 1) < 0.05, losses


def test_weight_decay_runs_in_the_port_only(mics):
    """The JAX trainer calls its optax chain's update without the
    parameters, so add_decayed_weights raises and `-prism_weight_decay`
    fails there (ROADMAP Queue 3); the port applies the decay."""
    kw = dict(size=24, latent_dim=4, steps=3, batch=4, lr=1e-2,
              momentum=0.9)
    with pytest.raises(ValueError):
        jq.train_quality(mics, weight_decay=1e-2, **kw)
    with carried_init(QualityAE=ae_init(4, 24)):
        plain = tq.train_quality(mics, device=CPU, **kw)
        decayed = tq.train_quality(mics, weight_decay=1e-2, device=CPU, **kw)
    k = "Conv_1.kernel"
    assert float(decayed.params[k].norm()) < float(plain.params[k].norm())


def test_quality_scores_with_carried_model(mics):
    """The scores of one model (the JAX package's, carried) in both
    packages."""
    p = ae_init(4, 24, seed=1)
    z = np.asarray(jax.jit(jq.QualityAE(latent_dim=4).apply)(
        p, jq.featurize(mics, 24))[0])
    jm = jq.QualityModel(params=p, latent_dim=4, size=24, mu=z.mean(0),
                         sigma=z.std(0) + 1e-6)
    tm = tq.QualityModel(tio.from_flax(np_tree(p)), 4, 24, jm.mu, jm.sigma)
    close(tq.quality_scores(tm, mics, device=CPU),
          jq.quality_scores(jm, mics), rel=1e-4)
