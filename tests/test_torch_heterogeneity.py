"""Parity of pyp_tpu_torch/models/heterogeneity.py with the JAX package on
the CPU, on tests/test_refine3d.py's particles (box 32 at 2 Å/px) and
tests/test_heterogeneity.py's tilt stacks: the data both trainers
compare against (the spectra at the mask points, the centring phase, the
CTF and the pose-rotated coordinates); the SPA and tilt losses and their
gradients for a given noise draw, against the JAX trainers' loss
functions written out with `encoder.apply` / `decoder.apply`; the pooled
posteriors; embed, embed_tilt, decode_volume and latent_pca with carried
weights; checkpoints crossing the packages; and a few training steps in
each branch, whose loss falls. The JAX trainers draw their noise with
`jax.random` inside the step, so training itself is compared by what it
reaches (`tests/test_heterogeneity.py`'s two-state separation is slow-
marked there; `chip_smoke.py` holds it at full size on the card).

Tolerances: spectra, phases, CTF and coordinates 1e-5 x max; losses
1e-5 relative and gradients 1e-4 x max; embeddings 1e-5 x max; decoded
volumes 1e-4 x max (float32 against the JAX package's float64 inverse
FFT); PCA equal to float64 rounding.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyp_tpu.models import heterogeneity as jh
from pyp_tpu.ops.fourier_slice import gather_2d_hermitian, image_to_fourier
from pyp_tpu.ops.refine3d import _ctf_at_points, make_mask_points
from pyp_tpu_torch.models import heterogeneity as th
from pyp_tpu_torch.models import io as tio
from tests.test_refine3d import N, PIXEL, make_particles, make_volume
from tests.test_torch_models import _two_threads, carried_init, close, np_tree

assert _two_threads   # the module fixture shared with test_torch_models
CPU = "cpu"
LATENT, HIDDEN = 3, 16
SCOPE = dict(voltage_kv=300.0, cs_mm=2.7, w=0.07)


@pytest.fixture(scope="module")
def particles():
    vol = make_volume(seed=0)
    imgs, cp, truth = make_particles(vol, n_particles=10, noise=0.1, seed=1)
    poses = np.stack([truth["phi"], truth["theta"], truth["psi"],
                      -truth["shifts"][:, 0], -truth["shifts"][:, 1]],
                     1).astype(np.float32)
    return np.asarray(imgs, np.float32), poses, np.asarray(cp, np.float32)


@pytest.fixture(scope="module")
def tilts():
    from tests.test_heterogeneity import make_tilt_stacks

    stacks, poses, ctf = make_tilt_stacks(make_volume(seed=3), 4, T=3, seed=2)
    poses[..., 3:] = np.random.RandomState(3).uniform(-1, 1, (4, 3, 2))
    return stacks, poses, ctf


@functools.lru_cache(maxsize=None)
def flax_params(seed=0):
    enc = jh.Encoder(latent_dim=LATENT)
    dec = jh.SliceDecoder(latent_dim=LATENT, hidden=HIDDEN)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    ep = jax.jit(enc.init)(k1, jnp.zeros((1, N, N, 1)))
    dp = jax.jit(dec.init)(k2, jnp.zeros((1, 5, 3)), jnp.zeros((1, 5, LATENT)))
    return ep, dp


def jax_data(stack, poses, ctf_params, mask_pts):
    """The JAX trainers' data preparation, written out."""
    pts = jnp.asarray(mask_pts)
    X = image_to_fourier(jnp.asarray(stack))
    xv = jax.vmap(lambda Xi: gather_2d_hermitian(Xi, pts))(X)
    ph = 2.0 * jnp.pi * (pts[None, :, 0] * poses[:, 3, None]
                         + pts[None, :, 1] * poses[:, 4, None]) / N
    xv = xv * jax.lax.complex(jnp.cos(ph), -jnp.sin(ph))
    xv = xv / (jnp.sqrt(jnp.mean(jnp.abs(xv) ** 2, axis=1, keepdims=True))
               + 1e-8)
    ctf = jax.vmap(lambda cp: _ctf_at_points(
        pts, N, PIXEL, cp[0], cp[1], cp[2], 300.0, 2.7, 0.07, cp[3]))(
            jnp.asarray(ctf_params))
    coords = jh._slice_coords(pts, jnp.asarray(poses), N)
    return [np.asarray(a) for a in (xv, ctf, coords)]


def port_data(stack, poses, ctf_params, mask_pts):
    t = [torch.as_tensor(np.asarray(a, np.float32))
         for a in (stack, poses, ctf_params, mask_pts)]
    return th._slice_data(*t, N, PIXEL, **SCOPE)


def test_data_preparation_matches(particles):
    stack, poses, cp = particles
    mask_pts = make_mask_points(N, PIXEL, 60.0, 5.0)
    want = jax_data(stack, poses, cp, mask_pts)
    got = port_data(stack, poses, cp, mask_pts)
    for g, w in zip(got, want):
        close(g, w)
    std = th._standardized(stack)
    np.testing.assert_array_equal(
        std, (stack - stack.mean(axis=(1, 2), keepdims=True))
        / (stack.std(axis=(1, 2), keepdims=True) + 1e-6))


def _port_models():
    ep, dp = flax_params()
    enc, dec = th.Encoder(LATENT, N), th.SliceDecoder(LATENT, HIDDEN)
    enc.load_state_dict(tio.from_flax(np_tree(ep)))
    dec.load_state_dict(tio.from_flax(np_tree(dp)))
    return enc, dec


def _grads_close(enc, dec, jgrads):
    ge, gd = (tio.from_flax(np_tree(g)) for g in jgrads)
    for mod, want in ((enc, ge), (dec, gd)):
        for k, p in mod.named_parameters():
            close(p.grad, want[k].numpy(), rel=1e-4)


def test_spa_loss_and_gradient_for_a_given_noise(particles):
    stack, poses, cp = particles
    mask_pts = make_mask_points(N, PIXEL, 60.0, 5.0)
    xv, ctf, coords = jax_data(stack, poses, cp, mask_pts)
    imgs = th._standardized(stack)[..., None]
    idx = np.array([3, 0, 7, 7, 5])
    eps = np.random.RandomState(4).randn(len(idx), LATENT).astype(np.float32)
    G = len(mask_pts)
    enc_j = jh.Encoder(latent_dim=LATENT)
    dec_j = jh.SliceDecoder(latent_dim=LATENT, hidden=HIDDEN)

    def loss_fn(ps):          # the JAX trainer's, with eps given
        ep, dp = ps
        mu, logvar = enc_j.apply(ep, jnp.asarray(imgs[idx]))
        z = mu + jnp.exp(0.5 * logvar) * eps
        zb = jnp.broadcast_to(z[:, None, :], (z.shape[0], G, LATENT))
        pred = dec_j.apply(dp, jnp.asarray(coords[idx]), zb) * ctf[idx]
        recon = jnp.mean(jnp.abs(pred - xv[idx]) ** 2)
        kl = -0.5 * jnp.mean(1 + logvar - mu ** 2 - jnp.exp(logvar))
        return recon + 1e-2 * kl

    want, grads = jax.value_and_grad(loss_fn)(flax_params())
    enc, dec = _port_models()
    t = torch.as_tensor
    loss = th._het_loss(enc, dec, t(imgs[idx]).permute(0, 3, 1, 2),
                        t(coords[idx]), t(ctf[idx]), t(xv[idx]), t(eps), 1e-2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    _grads_close(enc, dec, grads)


def test_tilt_loss_and_gradient_for_a_given_noise(tilts):
    stacks, poses, cp = tilts
    P, T = stacks.shape[:2]
    mask_pts = make_mask_points(N, PIXEL, 60.0, 5.0)
    G = len(mask_pts)
    xv, ctf, coords = (a.reshape((P, T) + a.shape[1:]) for a in jax_data(
        stacks.reshape(P * T, N, N), poses.reshape(P * T, 5),
        cp.reshape(P * T, 4), mask_pts))
    imgs = th._standardized(stacks)
    tw = np.random.RandomState(5).uniform(0.5, 1.0, (P, T)).astype(np.float32)
    idx = np.array([2, 0, 3])
    b = len(idx)
    eps = np.random.RandomState(6).randn(b, LATENT).astype(np.float32)
    enc_j = jh.Encoder(latent_dim=LATENT)
    dec_j = jh.SliceDecoder(latent_dim=LATENT, hidden=HIDDEN)

    def loss_fn(ps):          # the JAX tilt trainer's, with eps given
        ep, dp = ps
        mu_t, lv_t = enc_j.apply(ep, jnp.asarray(imgs[idx]).reshape(
            b * T, N, N, 1))
        mu, var = jh._pool_gaussians(mu_t.reshape(b, T, LATENT),
                                     lv_t.reshape(b, T, LATENT))
        z = mu + jnp.sqrt(var) * eps
        zb = jnp.broadcast_to(z[:, None, None, :], (b, T, G, LATENT))
        pred = dec_j.apply(dp, jnp.asarray(coords[idx]).reshape(b * T, G, 3),
                           zb.reshape(b * T, G, LATENT))
        pred = pred.reshape(b, T, G) * ctf[idx]
        resid = jnp.abs(pred - xv[idx]) ** 2 * tw[idx][..., None]
        recon = jnp.sum(resid) / jnp.maximum(jnp.sum(tw[idx]) * G, 1.0)
        kl = -0.5 * jnp.mean(1 + jnp.log(var) - mu ** 2 - var)
        return recon + 1e-2 * kl

    want, grads = jax.value_and_grad(loss_fn)(flax_params())
    enc, dec = _port_models()
    t = torch.as_tensor
    loss = th._het_tilt_loss(enc, dec, t(imgs[idx]), t(coords[idx]),
                             t(ctf[idx]), t(xv[idx]), t(tw[idx]), t(eps),
                             1e-2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    _grads_close(enc, dec, grads)


def test_pool_gaussians():
    rng = np.random.RandomState(7)
    mu, lv = rng.randn(4, 3, 5).astype(np.float32), rng.randn(4, 3, 5).astype(
        np.float32)
    for axis in (1, 0):
        for g, w in zip(th._pool_gaussians(torch.as_tensor(mu),
                                           torch.as_tensor(lv), axis),
                        jh._pool_gaussians(jnp.asarray(mu), jnp.asarray(lv),
                                           axis)):
            close(g, np.asarray(w))


def _models(mask_pts):
    ep, dp = flax_params()
    common = dict(latent_dim=LATENT, n=N, pixel_size=PIXEL,
                  mask_pts=mask_pts, hidden=HIDDEN)
    return (jh.HetModel(enc_params=ep, dec_params=dp, **common),
            th.HetModel(enc_params=tio.from_flax(np_tree(ep)),
                        dec_params=tio.from_flax(np_tree(dp)), **common))


def test_embed_decode_and_pca_with_carried_weights(particles, tilts):
    jm, tm = _models(make_mask_points(N, PIXEL, 60.0, 5.0))
    stack = particles[0]
    close(th.embed(tm, stack, device=CPU), jh.embed(jm, stack))
    close(th.embed_tilt(tm, tilts[0], device=CPU), jh.embed_tilt(jm, tilts[0]))
    z = np.array([0.3, -1.0, 0.5], np.float32)
    close(th.decode_volume(tm, z, device=CPU), jh.decode_volume(jm, z),
          rel=1e-4)
    lat = np.random.RandomState(8).randn(12, LATENT)
    for g, w in zip(th.latent_pca(lat), jh.latent_pca(lat)):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross(writer, particles, tmp_path):
    jm, tm = _models(make_mask_points(N, PIXEL, 60.0, 5.0))
    path = tmp_path / "het_model.npz"
    (jh if writer == "jax" else th).save_model(jm if writer == "jax" else tm,
                                               path)
    jb, tb = jh.load_model(path), th.load_model(path)
    for back in (jb, tb):
        assert (back.latent_dim, back.n, back.hidden) == (LATENT, N, HIDDEN)
        assert abs(back.pixel_size - PIXEL) < 1e-9
        np.testing.assert_array_equal(back.mask_pts, jm.mask_pts)
    stack = particles[0]
    close(th.embed(tb, stack, device=CPU), jh.embed(jb, stack))
    close(th.embed(tb, stack, device=CPU), jh.embed(jm, stack))


def _loss_at_mean(model, data, tilt):
    """The trainer's loss over every particle with the noise at zero."""
    enc, dec = th.Encoder(model.latent_dim, model.n), th.SliceDecoder(
        model.latent_dim, model.hidden)
    enc.load_state_dict(model.enc_params)
    dec.load_state_dict(model.dec_params)
    stack, poses, cp = data
    with torch.no_grad():
        if not tilt:
            xv, ctf, coords = port_data(stack, poses, cp, model.mask_pts)
            x = torch.as_tensor(th._standardized(stack))[:, None]
            eps = torch.zeros(len(stack), model.latent_dim)
            return th._het_loss(enc, dec, x, coords, ctf, xv, eps, 0.0).item()
        P, T = stack.shape[:2]
        xv, ctf, coords = (a.reshape((P, T) + a.shape[1:]) for a in port_data(
            stack.reshape(P * T, N, N), poses.reshape(P * T, 5),
            cp.reshape(P * T, 4), model.mask_pts))
        return th._het_tilt_loss(
            enc, dec, torch.as_tensor(th._standardized(stack)), coords, ctf,
            xv, torch.ones(P, T), torch.zeros(P, model.latent_dim), 0.0).item()


@pytest.mark.parametrize("branch", ["spa", "tilt"])
def test_training_lowers_the_loss(branch, particles, tilts):
    data = particles if branch == "spa" else tilts
    kw = dict(latent_dim=LATENT, hidden=HIDDEN, batch=4, lr=1e-2,
              high_res=5.0, seed=1, device=CPU)
    train = (th.train_heterogeneity if branch == "spa"
             else th.train_heterogeneity_tilt)
    ep, dp = flax_params()
    with carried_init(Encoder=ep, SliceDecoder=dp):
        start = train(*data, PIXEL, steps=0, **kw)
        trained = train(*data, PIXEL, steps=60, **kw)
    again = train(*data, PIXEL, steps=60, **kw)     # the port's own init
    before = _loss_at_mean(start, data, branch == "tilt")
    after = _loss_at_mean(trained, data, branch == "tilt")
    assert after < 0.9 * before, (before, after)
    assert _loss_at_mean(again, data, branch == "tilt") < before
