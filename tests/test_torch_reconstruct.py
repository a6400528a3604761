"""Parity of pyp_tpu_torch.ops.reconstruct and pyp_tpu_torch.state against
pyp_tpu.ops.reconstruct on the CPU, at box 32 / 2 Å per pixel with the
helpers of tests/test_refine3d.py.

Tolerances: accumulators 1e-4 relative to their maximum (the scatter sums
in another order); maps atol 1e-4 * max|map|; FSC curves atol 1e-3 (a
ratio of shell sums of those maps).

One sample per particle is decided by the last bit of each package's own
rotation matrix: on the ky = -n/2 row at kx = 0, |q| = n/2 exactly, so
whether it lies inside the Nyquist sphere is a rounding question. The
particle images here are band-limited below wavenumber 7 (the crop grid's
Nyquist is 8), so that sample carries no signal, and accumulator
comparisons leave out the voxels its trilinear corners reach (within 2 of
the padded grid's Nyquist shell)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_refine3d import N, PIXEL, make_particles, make_volume

from pyp_tpu.ops import reconstruct as jrec
from pyp_tpu_torch import state
from pyp_tpu_torch.ops import reconstruct as trec


def close(port, ref, atol_rel=1e-4, mask=None):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    if mask is not None:
        port, ref = port[mask], ref[mask]
    np.testing.assert_allclose(port, ref, rtol=0,
                               atol=atol_rel * float(np.abs(ref).max()))


def inside_nyquist(pn):
    """Padded-grid voxels that no corner of a Nyquist-shell sample reaches."""
    k = np.fft.fftfreq(pn) * pn
    kx = np.arange(pn // 2 + 1)
    r = np.sqrt(k[:, None, None] ** 2 + k[None, :, None] ** 2 + kx[None, None, :] ** 2)
    return r < pn // 2 - 2


def bandlimit(imgs, kmax=7):
    """Zero every Fourier component of the images at |k| >= kmax."""
    n = imgs.shape[-1]
    ky = np.fft.fftfreq(n)[:, None] * n
    kx = np.fft.rfftfreq(n)[None, :] * n
    keep = np.sqrt(ky ** 2 + kx ** 2) < kmax
    return np.fft.irfft2(np.fft.rfft2(imgs) * keep, s=(n, n)).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    vol = make_volume()
    imgs, cp, truth = make_particles(vol, n_particles=24, noise=0.15, seed=7)
    poses = np.stack([truth["phi"], truth["theta"], truth["psi"],
                      -truth["shifts"][:, 0], -truth["shifts"][:, 1]],
                     1).astype(np.float32)
    return vol, bandlimit(np.array(imgs)), np.array(cp), poses


def t(x):
    return torch.from_numpy(np.array(x))


class TestAccumulate:
    @pytest.mark.parametrize("sym", ["C1", "C2"])
    def test_accumulate(self, data, sym):
        _, imgs, cp, poses = data
        subset = np.arange(24) % 2
        w = np.linspace(0.5, 1.0, 24).astype(np.float32)
        ref = jrec.accumulate(jnp.asarray(imgs), jnp.asarray(poses),
                              jnp.asarray(cp), jnp.asarray(subset),
                              jnp.asarray(w), N, PIXEL, symmetry=sym)
        out = trec.accumulate(t(imgs), t(poses), t(cp), t(subset), t(w), N,
                              PIXEL, symmetry=sym)
        m = inside_nyquist(2 * N)
        for o, r in zip(out, ref):
            close(o, r, mask=m)

    def test_merge_equals_single_pass(self, data):
        _, imgs, cp, poses = data
        sub, w = t(np.arange(24) % 2), torch.ones(24)
        args = [t(imgs), t(poses), t(cp), sub, w]
        whole = trec.accumulate(*args, N, PIXEL)
        a = trec.accumulate(*(x[:10] for x in args), N, PIXEL)
        b = trec.accumulate(*(x[10:] for x in args), N, PIXEL)
        for m_, w_ in zip(trec.merge_accumulators([a, b]), whole):
            close(m_, w_, atol_rel=1e-5)


class TestFinalize:
    def test_finalize_from_same_accumulators(self, data):
        _, imgs, cp, poses = data
        acc = jrec.accumulate(jnp.asarray(imgs), jnp.asarray(poses),
                              jnp.asarray(cp), jnp.asarray(np.arange(24) % 2),
                              jnp.ones(24), N, PIXEL)
        # the JAX finalize consumes (donates) its accumulators: copy first
        out = trec.finalize(state.from_jax(jrec.Accumulators(*(np.asarray(a) for a in acc))), N)
        ref = jrec.finalize(acc, N)
        for f in ("volume", "half1", "half2"):
            close(getattr(out, f), getattr(ref, f))
        close(out.freqs, ref.freqs, atol_rel=1e-6)
        np.testing.assert_allclose(out.fsc.numpy(), np.asarray(ref.fsc), atol=1e-3)


class TestReconstruct:
    @pytest.mark.parametrize("crop_to", [None, 16])
    def test_reconstruct(self, data, crop_to):
        vol, imgs, cp, poses = data
        ref = jrec.reconstruct(jnp.asarray(imgs), jnp.asarray(poses), cp, PIXEL,
                               batch=10, crop_to=crop_to)
        out = trec.reconstruct(imgs, poses, cp, PIXEL, batch=10,
                               crop_to=crop_to, device="cpu")
        n_rec = crop_to or N
        assert out.volume.shape == (n_rec,) * 3
        for f in ("volume", "half1", "half2"):
            close(getattr(out, f), getattr(ref, f))
        np.testing.assert_allclose(out.fsc.numpy(), np.asarray(ref.fsc), atol=1e-3)
        if crop_to is None:
            from pyp_tpu_torch.core import fsc as tfsc

            _, curve = tfsc.fsc(out.volume, t(vol))
            assert curve[1:6].min() > 0.8   # inside the images' band

    def test_batch_never_above_callers(self, data, monkeypatch):
        """The insertion batch is the caller's, even below 64 particles."""
        _, imgs, cp, poses = data
        sizes = []
        inner = trec.accumulate

        def spy(stack, *a, **k):
            sizes.append(stack.shape[0])
            return inner(stack, *a, **k)

        monkeypatch.setattr(trec, "accumulate", spy)
        trec.reconstruct(imgs, poses, cp, PIXEL, batch=8, device="cpu")
        assert sizes == [8, 8, 8]


class TestStateRoundTrip:
    def _acc(self, data):
        _, imgs, cp, poses = data
        return jrec.accumulate(jnp.asarray(imgs), jnp.asarray(poses),
                               jnp.asarray(cp), jnp.asarray(np.arange(24) % 2),
                               jnp.ones(24), N, PIXEL)

    def test_jax_save_port_load(self, data, tmp_path):
        acc = self._acc(data)
        jrec.save_accumulators(acc, tmp_path / "acc.npz")
        back = trec.load_accumulators(tmp_path / "acc.npz", device="cpu")
        out = trec.finalize(back, N)
        ref = jrec.finalize(acc, N)
        close(out.volume, ref.volume)
        close(out.half1, ref.half1)

    def test_port_save_jax_load(self, data, tmp_path):
        _, imgs, cp, poses = data
        acc = trec.accumulate(t(imgs), t(poses), t(cp), t(np.arange(24) % 2),
                              torch.ones(24), N, PIXEL)
        trec.save_accumulators(acc, tmp_path / "acc.npz")
        with np.load(tmp_path / "acc.npz") as z:
            assert sorted(z.files) == ["den1", "den2", "num1", "num2"]
            assert z["num1"].dtype == np.complex64 and z["den1"].dtype == np.float32
        back = jrec.load_accumulators(tmp_path / "acc.npz")
        ref = jrec.finalize(back, N)
        out = trec.finalize(acc, N)
        close(out.volume, ref.volume)
        close(out.half2, ref.half2)

    def test_from_jax_to_numpy(self):
        rng = np.random.RandomState(0)
        arrays = {"map": rng.randn(4, 4, 4), "poses": rng.randn(3, 5).astype(np.float32)}
        ts = state.from_jax(arrays, "cpu")
        assert ts["map"].dtype == torch.float32 and ts["poses"].dtype == torch.float32
        back = state.to_numpy(ts)
        np.testing.assert_allclose(back["map"], arrays["map"], rtol=1e-6)
        np.testing.assert_array_equal(back["poses"], arrays["poses"])
        res = state.to_numpy(state.from_jax(trec.Reconstruction(*(rng.randn(2) for _ in range(5)))))
        assert isinstance(res, trec.Reconstruction)
