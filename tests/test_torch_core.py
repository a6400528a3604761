"""Parity of pyp_tpu_torch.core against pyp_tpu.core on the CPU: the same
seeded numpy inputs go through the JAX function and its torch port.
Tolerance: rtol 1e-5, atol 1e-5 * max|reference| (float32 on both sides;
FFT sums differ in order between the two libraries)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyp_tpu.core import ctf as jctf
from pyp_tpu.core import fft as jfft
from pyp_tpu.core import filters as jfilters
from pyp_tpu.core import fsc as jfsc
from pyp_tpu.core import geometry as jgeom
from pyp_tpu_torch.core import ctf as tctf
from pyp_tpu_torch.core import fft as tfft
from pyp_tpu_torch.core import filters as tfilters
from pyp_tpu_torch.core import fsc as tfsc
from pyp_tpu_torch.core import geometry as tgeom


def close(port, ref, rtol=1e-5, atol_rel=1e-5):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    atol = atol_rel * max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol)


def angles(n=64, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.uniform(0, 360, n).astype(np.float32),
            rng.uniform(0, 180, n).astype(np.float32),
            rng.uniform(-180, 180, n).astype(np.float32))


def volume(n=16, seed=0):
    return np.random.RandomState(seed).randn(n, n, n).astype(np.float32)


class TestGeometry:
    def test_euler_to_matrix(self):
        phi, theta, psi = angles()
        ref = jgeom.euler_to_matrix(jnp.asarray(phi), jnp.asarray(theta),
                                    jnp.asarray(psi))
        out = tgeom.euler_to_matrix(torch.from_numpy(phi),
                                    torch.from_numpy(theta),
                                    torch.from_numpy(psi))
        close(out, ref)

    def test_euler_to_matrix_scalars(self):
        close(tgeom.euler_to_matrix(30.0, 45.0, 0.0),
              jgeom.euler_to_matrix(30.0, 45.0, 0.0))

    def test_matrix_to_euler(self):
        phi, theta, psi = angles(seed=1)
        R = np.array(jgeom.euler_to_matrix(jnp.asarray(phi),
                                             jnp.asarray(theta),
                                             jnp.asarray(psi)))
        ref = jgeom.matrix_to_euler(jnp.asarray(R))
        out = tgeom.matrix_to_euler(torch.from_numpy(R))
        for o, r in zip(out, ref):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=2e-3)

    @pytest.mark.parametrize("sym", ["C1", "C4", "D2", "D7", "T", "O", "I"])
    def test_symmetry_matrices(self, sym):
        np.testing.assert_array_equal(tgeom.apply_symmetry_matrices(sym),
                                      jgeom.apply_symmetry_matrices(sym))


class TestCtf:
    @pytest.mark.parametrize("kv", [120.0, 200.0, 300.0])
    def test_wavelength(self, kv):
        close(tctf.wavelength(kv), jctf.wavelength(kv))
        assert tctf.wavelength_host(kv) == jctf.wavelength_host(kv)

    def test_defocus_and_chi(self):
        rng = np.random.RandomState(2)
        g = rng.uniform(0, 0.25, 500).astype(np.float32)
        az = rng.uniform(-np.pi, np.pi, 500).astype(np.float32)
        df_ref = jctf.defocus_at_azimuth(15000.0, 14000.0, 30.0, jnp.asarray(az))
        df_out = tctf.defocus_at_azimuth(15000.0, 14000.0, 30.0, torch.from_numpy(az))
        close(df_out, df_ref)
        chi_ref = jctf.chi(jnp.asarray(g), df_ref, 300.0, 2.7, 0.3)
        chi_out = tctf.chi(torch.from_numpy(g), df_out, 300.0, 2.7, 0.3)
        close(chi_out, chi_ref)


class TestFft:
    @pytest.mark.parametrize("out", [(10, 12), (24, 20)])
    def test_fourier_crop(self, out):
        imgs = np.random.RandomState(3).randn(3, 16, 16).astype(np.float32)
        close(tfft.fourier_crop(torch.from_numpy(imgs), out),
              jfft.fourier_crop(jnp.asarray(imgs), out))

    @pytest.mark.parametrize("out", [(8, 8, 8), (20, 20, 20)])
    def test_fourier_crop_3d(self, out):
        vol = volume()
        close(tfft.fourier_crop_3d(torch.from_numpy(vol), out),
              jfft.fourier_crop_3d(jnp.asarray(vol), out))


class TestFilters:
    def test_masks(self):
        close(tfilters.soft_spherical_mask(17, 5.5, 3.0),
              jfilters.soft_spherical_mask(17, 5.5, 3.0))
        close(tfilters.soft_circular_mask(20, 7.0, 4.0),
              jfilters.soft_circular_mask(20, 7.0, 4.0))

    def test_lowpass_filter_3d(self):
        vol = volume(seed=4)
        close(tfilters.lowpass_filter_3d(torch.from_numpy(vol), 2.0, 6.0),
              jfilters.lowpass_filter_3d(jnp.asarray(vol), 2.0, 6.0))

    @pytest.mark.parametrize("masked", [False, True])
    def test_normalize_images(self, masked):
        imgs = (3.0 + 2.0 * np.random.RandomState(5).randn(4, 12, 12)).astype(np.float32)
        mask = np.array(jfilters.soft_circular_mask(12, 4.0, 2.0)) if masked else None
        ref = jfilters.normalize_images(jnp.asarray(imgs), None if mask is None else jnp.asarray(mask))
        out = tfilters.normalize_images(torch.from_numpy(imgs), None if mask is None else torch.from_numpy(mask))
        close(out, ref)


class TestFsc:
    def _maps(self):
        a = volume(n=16, seed=6)
        b = a + 0.7 * volume(n=16, seed=7)
        return a, b

    def test_fsc_curve(self):
        a, b = self._maps()
        fr, cr = jfsc.fsc(jnp.asarray(a), jnp.asarray(b))
        fo, co = tfsc.fsc(torch.from_numpy(a), torch.from_numpy(b))
        close(fo, fr)
        close(co, cr, rtol=1e-4, atol_rel=1e-5)

    @pytest.mark.parametrize("thr", [0.143, 0.5, -2.0])
    def test_resolution_at_threshold(self, thr):
        freqs = np.arange(16, dtype=np.float32) / 32 + 1 / 64
        curve = np.linspace(1.0, -0.1, 16).astype(np.float32)
        ref = float(jfsc.resolution_at_threshold(freqs, curve, 1.5, thr))
        out = float(tfsc.resolution_at_threshold(freqs, curve, 1.5, thr))
        assert abs(out - ref) <= 1e-5 * abs(ref)

    def test_weights_and_filter(self):
        a, _ = self._maps()
        curve = np.linspace(1.0, -0.2, 8).astype(np.float32)
        close(tfsc.fsc_weights(torch.from_numpy(curve)), jfsc.fsc_weights(jnp.asarray(curve)))
        close(tfsc.radial_shell_filter_3d((16, 16, 16), torch.from_numpy(curve)),
              jfsc.radial_shell_filter_3d((16, 16, 16), jnp.asarray(curve)))
        close(tfsc.apply_fsc_filter(torch.from_numpy(a), torch.from_numpy(np.clip(curve, 0, 1))),
              jfsc.apply_fsc_filter(jnp.asarray(a), jnp.asarray(np.clip(curve, 0, 1))))
