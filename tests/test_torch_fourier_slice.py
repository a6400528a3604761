"""Parity of pyp_tpu_torch.ops.fourier_slice against pyp_tpu.ops.fourier_slice
on the CPU, at box 32 / 2 Å per pixel with the volume and particle helpers
of tests/test_refine3d.py. Tolerances: transforms and gathers atol
1e-4 * max|reference|; accumulators 1e-4 relative to their maximum,
because the scatter sums in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_refine3d import N, make_volume

from pyp_tpu.core.geometry import euler_to_matrix as j_e2m
from pyp_tpu.ops import fourier_slice as jfs
from pyp_tpu_torch.ops import fourier_slice as tfs


def close(port, ref, atol_rel=1e-4):
    port = port.detach().numpy()
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    np.testing.assert_allclose(port, ref, rtol=0,
                               atol=atol_rel * float(np.abs(ref).max()))


def t(x):
    return torch.from_numpy(np.array(x))


def poses(n=6, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.uniform(0, 360, n).astype(np.float32),
            np.degrees(np.arccos(rng.uniform(-1, 1, n))).astype(np.float32),
            rng.uniform(0, 360, n).astype(np.float32))


def rotations(n=6, seed=0):
    """The same rotation matrices for both packages. (Each package's own
    euler_to_matrix differs in the last bit, and on the Nyquist row
    (ky = -n/2, kx = 0) |q| is exactly n/2 in exact arithmetic, so the
    inside-the-sphere test there is decided by that bit.)"""
    phi, theta, psi = poses(n, seed)
    Rj = j_e2m(jnp.asarray(phi), jnp.asarray(theta), jnp.asarray(psi))
    return Rj, t(Rj)


@pytest.fixture(scope="module")
def vol():
    return make_volume()


class TestTransforms:
    @pytest.mark.parametrize("pad", [1, 2])
    def test_image_to_fourier_and_back(self, pad):
        imgs = np.random.RandomState(1).randn(3, N, N).astype(np.float32)
        ref = jfs.image_to_fourier(jnp.asarray(imgs), pad=pad)
        out = tfs.image_to_fourier(t(imgs), pad=pad)
        close(out, ref)
        if pad == 1:
            close(tfs.fourier_to_image(out, N), jfs.fourier_to_image(ref, N))

    @pytest.mark.parametrize("pad", [1, 2, 3])
    def test_volume_transforms(self, vol, pad):
        ref = jfs.volume_to_fourier(jnp.asarray(vol), pad=pad)
        out = tfs.volume_to_fourier(t(vol), pad=pad)
        close(out, ref)
        close(tfs.fourier_to_volume(out, N, pad), jfs.fourier_to_volume(ref, N, pad))


class TestGathers:
    def test_gather_3d(self, vol):
        Fj = jfs.volume_to_fourier(jnp.asarray(vol))
        Ft = tfs.volume_to_fourier(t(vol))
        q = np.random.RandomState(2).uniform(-N / 2, N / 2, (5, 40, 3)).astype(np.float32)
        close(tfs.gather_3d_hermitian(Ft, t(q), scale=2.0),
              jfs.gather_3d_hermitian(Fj, jnp.asarray(q), scale=2.0))

    def test_gather_2d_single_and_batched(self):
        imgs = np.random.RandomState(3).randn(4, N, N).astype(np.float32)
        Xj = jfs.image_to_fourier(jnp.asarray(imgs), pad=2)
        Xt = tfs.image_to_fourier(t(imgs), pad=2)
        p = np.random.RandomState(4).uniform(-N / 2, N / 2, (7, 30, 2)).astype(np.float32)
        ref = np.stack([np.asarray(jfs.gather_2d_hermitian(Xj[b], jnp.asarray(p), scale=2.0))
                        for b in range(4)])
        close(tfs.gather_2d_hermitian(Xt, t(p), scale=2.0), ref)
        close(tfs.gather_2d_hermitian(Xt[1], t(p), scale=2.0), ref[1])

    def test_slice_coords_and_project(self, vol):
        Rj, Rt = rotations()
        close(tfs.slice_coords(Rt, N), jfs.slice_coords(Rj, N), atol_rel=1e-5)
        close(tfs.project(tfs.volume_to_fourier(t(vol)), Rt, N),
              jfs.project(jfs.volume_to_fourier(jnp.asarray(vol)), Rj, N))


class TestInsertion:
    def _inputs(self, B=8, seed=5):
        rng = np.random.RandomState(seed)
        imgs = rng.randn(B, N, N).astype(np.float32)
        ctfs = rng.uniform(-1, 1, (B, N, N // 2 + 1)).astype(np.float32)
        subset = (np.arange(B) % 2).astype(np.int32)
        weights = rng.uniform(0.5, 1.0, B).astype(np.float32)
        return imgs, ctfs, subset, weights

    @pytest.mark.parametrize("pad", [2, 3])
    def test_insert_slices_halves(self, pad):
        imgs, ctfs, subset, weights = self._inputs()
        Rj, Rt = rotations(8, seed=6)
        ref = jfs.insert_slices_halves(
            jfs.image_to_fourier(jnp.asarray(imgs)), jnp.asarray(ctfs), Rj,
            jnp.asarray(subset), jnp.asarray(weights), N, pad=pad)
        out = tfs.insert_slices_halves(
            tfs.image_to_fourier(t(imgs)), t(ctfs), Rt, t(subset),
            t(weights), N, pad=pad)
        for o, r in zip(out, ref):
            close(o, r)

    def test_reconstruct_from_accumulators(self):
        imgs, ctfs, subset, weights = self._inputs(B=16, seed=7)
        Rj, Rt = rotations(16, seed=8)
        num, den, _, _ = jfs.insert_slices_halves(
            jfs.image_to_fourier(jnp.asarray(imgs)), jnp.asarray(ctfs), Rj,
            jnp.asarray(subset), jnp.asarray(weights), N)
        ref = jfs.reconstruct_from_accumulators(num, den, N, 2, 0.5)
        out = tfs.reconstruct_from_accumulators(t(num), t(den), N, 2, 0.5)
        close(out, ref)
        close(tfs.gridding_correction(N, 3), jfs.gridding_correction(N, 3), atol_rel=1e-5)

    def test_ewald_raises(self):
        imgs, ctfs, subset, weights = self._inputs(B=2)
        _, Rt = rotations(2)
        with pytest.raises(NotImplementedError, match="later PR"):
            tfs.insert_slices_halves(tfs.image_to_fourier(t(imgs)), t(ctfs),
                                     Rt, t(subset), t(weights), N,
                                     ewald_c=0.01)
