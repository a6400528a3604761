"""Ewald-sphere insertion (IEWALD ±1, ±2), likelihood blurring, dose
weighting and the projection helpers of the port against the JAX package
on the CPU (box 32, 2 Å per pixel, the volumes and particles of
tests/test_refine3d.py), and the quality oracles of tests/test_ewald.py
and tests/test_lblur.py run on the port.

Tolerances: projections atol 1e-4 * max|reference|; accumulators 1e-4
relative to their maximum (the scatter sums in another order), outside
the voxels within 2 of the padded grid's Nyquist shell where a
last-bit difference in each package's rotation matrix decides whether a
sample is inside the sphere (tests/test_torch_reconstruct.py); maps atol
1e-4 * max|map|, FSC atol 1e-3. accumulate and reconstruct are compared at
300 kV: the oracles' 1 kV makes chi reach ~10^3 rad, where the two
packages' float32 CTFs differ in the fourth digit (the strong curvature
itself is compared through insert_slices_halves). The oracles keep the
JAX tests' bars.

At IEWALD ±2 the port scales the reference per particle by
`ref_amplitude`; the JAX package inserts it unscaled. The parity tests
patch that amplitude to 1 (`unfitted`), which is the JAX insertion, and
test_fitted_insertion_is_the_jax_insertion_of_the_scaled_reference holds
the fitted insertion to the JAX insertion of each particle with its
reference scaled by the least-squares amplitude computed from JAX's
gathers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_refine3d import N, PIXEL, make_particles, make_volume
from test_torch_reconstruct import bandlimit, inside_nyquist

from pyp_tpu.core.ctf import wavelength
from pyp_tpu.core.filters import normalize_images
from pyp_tpu.core.geometry import euler_to_matrix as j_e2m
from pyp_tpu.ops import fourier_slice as jfs
from pyp_tpu.ops import reconstruct as jrec
from pyp_tpu.pipeline import refine as jref
from pyp_tpu_torch.core.geometry import euler_to_matrix
from pyp_tpu_torch.ops import fourier_slice as tfs
from pyp_tpu_torch.ops import reconstruct as trec
from pyp_tpu_torch.pipeline import refine as tref

PAD = 2
VOLTAGE = 1.0  # a 0.39 Å wavelength: strong curvature at box 32


def t(x):
    return torch.from_numpy(np.array(x))


def close(port, ref, atol_rel=1e-4, mask=None):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    if mask is not None:
        port, ref = port[mask], ref[mask]
    np.testing.assert_allclose(port, ref, rtol=0,
                               atol=atol_rel * float(np.abs(ref).max()))


def angles(n, seed):
    rng = np.random.RandomState(seed)
    return (rng.uniform(0, 360, n).astype(np.float32),
            np.degrees(np.arccos(rng.uniform(-1, 1, n))).astype(np.float32),
            rng.uniform(0, 360, n).astype(np.float32))


def rotations(n, seed):
    """The JAX package's rotation matrices, for both packages."""
    Rj = j_e2m(*(jnp.asarray(a) for a in angles(n, seed)))
    return Rj, t(Rj)


def curvature(sign=1):
    return sign * float(wavelength(VOLTAGE)) / (2.0 * N * PIXEL)


@pytest.fixture(scope="module")
def vol():
    return make_volume(seed=0)


@pytest.fixture
def unfitted(monkeypatch):
    """The reference inserted unscaled at IEWALD ±2, as the JAX package
    inserts it."""
    monkeypatch.setattr(tfs, "ref_amplitude",
                        lambda pred, F: torch.ones(F.shape[0], device=F.device))


class TestProjections:
    @pytest.mark.parametrize("c", [0.0, 0.02, -0.01])
    def test_project_ewald(self, vol, c):
        Rj, Rt = rotations(5, 1)
        close(tfs.project_ewald(tfs.volume_to_fourier(t(vol), PAD), Rt, N, c),
              jfs.project_ewald(jfs.volume_to_fourier(jnp.asarray(vol), PAD), Rj, N, c))

    def test_project_ewald_flat_is_project(self, vol):
        F = tfs.volume_to_fourier(t(vol), PAD)
        R = euler_to_matrix(t([15.0]), t([40.0]), t([70.0]))
        close(tfs.project_ewald(F, R, N, 0.0), tfs.project(F, R, N))

    def test_project_real(self, vol):
        phi, theta, psi = angles(6, 2)
        close(tfs.project_real(t(vol), phi, theta, psi),
              jfs.project_real(jnp.asarray(vol), phi, theta, psi), 1e-3)


class TestInsertion:
    def _inputs(self, B=8, seed=5):
        rng = np.random.RandomState(seed)
        imgs = bandlimit(rng.randn(B, N, N).astype(np.float32))
        ctfs = rng.uniform(-1, 1, (B, N, N // 2 + 1)).astype(np.float32)
        subset = (np.arange(B) % 2).astype(np.int32)
        weights = rng.uniform(0.5, 1.0, B).astype(np.float32)
        return imgs, ctfs, subset, weights

    def test_insert_slices(self):
        imgs, ctfs, _, weights = self._inputs()
        Rj, Rt = rotations(8, 6)
        ref = jfs.insert_slices(jfs.image_to_fourier(jnp.asarray(imgs)),
                                jnp.asarray(ctfs), Rj, N, weights=jnp.asarray(weights))
        out = tfs.insert_slices(tfs.image_to_fourier(t(imgs)), t(ctfs), Rt, N,
                                weights=t(weights))
        for o, r in zip(out, ref):
            close(o, r, mask=inside_nyquist(2 * N))

    @pytest.mark.parametrize("c,ref_based", [(0.02, False), (-0.02, False),
                                             (0.015, True)])
    def test_insert_slices_halves_ewald(self, vol, c, ref_based, unfitted):
        imgs, ctfs, subset, weights = self._inputs()
        Rj, Rt = rotations(8, 7)
        kj, kt = {}, {}
        if ref_based:
            chi = np.random.RandomState(8).uniform(
                0, 6.0, (8, N, N // 2 + 1)).astype(np.float32)
            kj = dict(ref_fourier=jfs.volume_to_fourier(jnp.asarray(vol), 2),
                      chi=jnp.asarray(chi))
            kt = dict(ref_fourier=tfs.volume_to_fourier(t(vol), 2), chi=t(chi))
        ref = jfs.insert_slices_halves(
            jfs.image_to_fourier(jnp.asarray(imgs)), jnp.asarray(ctfs), Rj,
            jnp.asarray(subset), jnp.asarray(weights), N, ewald_c=c, **kj)
        out = tfs.insert_slices_halves(
            tfs.image_to_fourier(t(imgs)), t(ctfs), Rt, t(subset),
            t(weights), N, ewald_c=c, **kt)
        for o, r in zip(out, ref):
            close(o, r, mask=inside_nyquist(2 * N))

    def test_chi_grids(self):
        rng = np.random.RandomState(9)
        cp = np.stack([rng.uniform(8000, 25000, 4), rng.uniform(8000, 25000, 4),
                       rng.uniform(0, 180, 4), rng.uniform(0, 1, 4)], 1).astype(np.float32)
        close(trec._chi_grids(N, PIXEL, t(cp), 300.0, 2.7, 0.07),
              jrec._chi_grids(N, PIXEL, jnp.asarray(cp), 300.0, 2.7, 0.07), 1e-5)


@pytest.fixture(scope="module")
def particles():
    v = make_volume(seed=3)
    stack, cp, truth = make_particles(v, n_particles=12, seed=4)
    poses = np.stack([truth["phi"], truth["theta"], truth["psi"],
                      truth["shifts"][:, 1], truth["shifts"][:, 0]],
                     axis=1).astype(np.float32)
    return v, bandlimit(np.array(stack)), np.array(cp), poses


class TestAccumulate:
    @pytest.mark.parametrize("kw", [
        {"doses": np.linspace(5.0, 40.0, 12).astype(np.float32)},
        {"iewald": 1},
        {"iewald": -2, "ref": True},
        {"iewald": 2, "ref": True, "norm": True},
        {"lblur": ((-4.0, 0.0, 4.0), (0.25, 0.5, 0.25)), "symmetry": "C2"},
    ], ids=["doses", "iewald1", "iewald-2", "iewald2_normalized", "lblur_c2"])
    def test_accumulate_options(self, particles, kw, unfitted):
        """iewald2_normalized: the loop's reconstruct_norm insertion,
        particles at zero mean and unit variance and the reference on its
        own scale (100x theirs), inserted unscaled as the JAX loop does."""
        v, stack, cp, poses = particles
        kw = dict(kw)
        use_ref = kw.pop("ref", False)
        if kw.pop("norm", False):
            stack = np.asarray(normalize_images(jnp.asarray(stack)))
            v = 100.0 * v / np.abs(v).max()
        sub, w = np.arange(12) % 2, np.linspace(0.5, 1.0, 12).astype(np.float32)
        kj, kt = dict(kw), dict(kw)
        if "doses" in kw:
            kj["doses"] = jnp.asarray(kw["doses"])
            kt["doses"] = t(kw["doses"])
        if use_ref:
            kj["ref_fourier"] = jfs.volume_to_fourier(jnp.asarray(v), 2)
            kt["ref_fourier"] = tfs.volume_to_fourier(t(v), 2)
        ref = jrec.accumulate(jnp.asarray(stack), jnp.asarray(poses),
                              jnp.asarray(cp), jnp.asarray(sub), jnp.asarray(w),
                              N, PIXEL, **kj)
        out = trec.accumulate(t(stack), t(poses), t(cp), t(sub), t(w), N,
                              PIXEL, **kt)
        for o, r in zip(out, ref):
            close(o, r, mask=inside_nyquist(2 * N))

    @pytest.mark.parametrize("kw", [
        {"iewald": 2, "ref": True, "crop_to": 16},
        {"lblur_nrot": 5, "lblur_range": 8.0},
    ], ids=["iewald2_crop", "lblur"])
    def test_reconstruct_options(self, particles, kw, unfitted):
        v, stack, cp, poses = particles
        kw = dict(kw)
        if kw.pop("ref", False):
            kw["ref_volume"] = v
        ref = jrec.reconstruct(jnp.asarray(stack), jnp.asarray(poses), cp,
                               PIXEL, batch=5, **kw)
        out = trec.reconstruct(stack, poses, cp, PIXEL, batch=5,
                               device="cpu", **kw)
        for f in ("volume", "half1", "half2"):
            close(getattr(out, f), getattr(ref, f))
        np.testing.assert_allclose(out.fsc.numpy(), np.asarray(ref.fsc), atol=1e-3)

    @pytest.mark.parametrize("kw", [{}, {"iewald": 2, "ref": True}],
                             ids=["plain", "iewald2"])
    def test_reconstruct_banded(self, particles, kw, unfitted):
        """The loop's band-limited reconstruction (16 Å at box 32: the crop
        grid is 16) gives the JAX loop's maps, on its scale, and FSC."""
        v, stack, cp, poses = particles
        kw = dict(kw)
        if kw.pop("ref", False):
            kw["ref_volume"] = v
        kw.update(subset=np.arange(12) % 2, batch=5)
        ref = jref.reconstruct_banded(stack, poses, cp, PIXEL, 16.0, kw)
        out = tref.reconstruct_banded(stack, poses, cp, PIXEL, 16.0, kw,
                                      device="cpu")
        assert out.volume.shape == (N,) * 3
        for f in ("volume", "half1", "half2"):
            close(getattr(out, f), getattr(ref, f))
        np.testing.assert_allclose(out.fsc.numpy(), np.asarray(ref.fsc), atol=1e-3)


def _curved_particles(vol, c, n=96, seed=0):
    """Particles formed on the curved sphere (port's project_ewald)."""
    phi, theta, psi = angles(n, seed)
    R = euler_to_matrix(t(phi), t(theta), t(psi))
    F = tfs.project_ewald(tfs.volume_to_fourier(t(vol), PAD), R, N, c)
    poses = np.stack([phi, theta, psi, np.zeros(n), np.zeros(n)], 1).astype(np.float32)
    return F, R, poses


def _reconstruct_with(F, R, c):
    B = F.shape[0]
    n1, d1, n2, d2 = tfs.insert_slices_halves(
        F, torch.ones((B, N, N // 2 + 1)), R, t(np.arange(B) % 2),
        torch.ones(B), N, pad=PAD, ewald_c=c)
    return tfs.reconstruct_from_accumulators(n1 + n2, d1 + d2, N, PAD,
                                             wiener=0.2).numpy()


def _cc(a, b):
    return np.corrcoef(np.asarray(a).ravel(), np.asarray(b).ravel())[0, 1]


class TestEwaldOracles:
    def test_curved_insertion_beats_planar_and_wrong_hand(self, vol):
        c = 0.02
        F, R, _ = _curved_particles(vol, c)
        cc_curved = _cc(_reconstruct_with(F, R, c), vol)
        cc_planar = _cc(_reconstruct_with(F, R, 0.0), vol)
        cc_flip = _cc(_reconstruct_with(F, R, -c), vol)
        assert cc_curved > cc_planar + 0.02 and cc_curved > 0.85, (cc_curved, cc_planar)
        # simple insertion is handedness-invariant
        assert abs(cc_flip - cc_curved) < 1e-5, (cc_flip, cc_curved)

    def test_zero_curvature_reduces_to_planar(self):
        v = make_volume(seed=1)
        F, R, _ = _curved_particles(v, 0.0, n=16)
        B = F.shape[0]
        n1, d1, n2, d2 = tfs.insert_slices_halves(
            F, torch.ones((B, N, N // 2 + 1)), R, t(np.arange(B) % 2),
            torch.ones(B), N, pad=PAD)
        b = tfs.reconstruct_from_accumulators(n1 + n2, d1 + d2, N, PAD, wiener=0.2)
        np.testing.assert_allclose(_reconstruct_with(F, R, 0.0), b.numpy(), atol=1e-5)

    def test_accumulate_wires_voltage_curvature(self):
        v = make_volume(seed=2)
        F, R, poses = _curved_particles(v, curvature(), seed=3)
        B = F.shape[0]
        cp = np.tile([15000.0, 15000.0, 0.0, 0.0], (B, 1)).astype(np.float32)
        ctfs = trec._ctf_grids(N, PIXEL, t(cp), VOLTAGE, 2.7, 0.07)
        imgs = tfs.fourier_to_image(F * ctfs, N)

        def run(iew):
            acc = trec.accumulate(imgs, t(poses), t(cp), t(np.arange(B) % 2),
                                  torch.ones(B), N, PIXEL, voltage_kv=VOLTAGE,
                                  iewald=iew)
            return _cc(trec.finalize(acc, N).volume.numpy(), v)

        cc1, cc0 = run(1), run(0)
        assert cc1 > cc0 + 0.01, (cc1, cc0)

    def _split_data(self, v, sign, n=96, seed=3):
        """Images with the branch-dependent complex transfer factor
        X = ctf+ F(s+) + conj(ctf+) F*(s-), ctf+ = (i/2) e^{i chi}."""
        rng = np.random.RandomState(seed)
        phi, theta, psi = angles(n, seed)
        cp = np.stack([rng.uniform(8000, 25000, n), rng.uniform(8000, 25000, n),
                       rng.uniform(0, 180, n), np.zeros(n)], 1).astype(np.float32)
        R = euler_to_matrix(t(phi), t(theta), t(psi))
        Fv = tfs.volume_to_fourier(t(v), PAD)
        q = tfs.slice_coords(R, N)
        curve = tfs._ewald_curve(R, N, curvature(sign))
        Fp = tfs.gather_3d_hermitian(Fv, q + curve, scale=float(PAD))
        Fm = tfs.gather_3d_hermitian(Fv, -q + curve, scale=float(PAD))
        chi = trec._chi_grids(N, PIXEL, t(cp), VOLTAGE, 2.7, 0.07)
        ctfp = 0.5j * torch.polar(torch.ones_like(chi), chi)
        imgs = tfs.fourier_to_image(ctfp * Fp + ctfp.conj() * Fm.conj(), N).numpy()
        poses = np.stack([phi, theta, psi, np.zeros(n), np.zeros(n)], 1).astype(np.float32)
        return imgs, poses, cp

    def _run(self, v, imgs, poses, cp, iew, ref=None):
        out = trec.reconstruct(imgs, poses, cp, PIXEL, voltage_kv=VOLTAGE,
                               iewald=iew, wiener=0.2, ref_volume=ref,
                               device="cpu")
        return _cc(out.volume.numpy(), v)

    def test_reference_based_beats_simple_and_wrong_hand(self, vol):
        imgs, poses, cp = self._split_data(vol, +1)
        cc_ref = self._run(vol, imgs, poses, cp, 2, vol)
        cc_flip = self._run(vol, imgs, poses, cp, -2, vol)
        cc_simple = self._run(vol, imgs, poses, cp, 1)
        assert cc_ref > cc_simple + 0.005 and cc_ref > cc_flip + 0.01, (
            cc_ref, cc_simple, cc_flip)
        assert cc_ref > 0.9, cc_ref

    def test_handedness_detectable_from_data(self):
        v = make_volume(seed=1)
        imgs, poses, cp = self._split_data(v, -1, seed=5)
        cc_minus = self._run(v, imgs, poses, cp, -2, v)
        cc_plus = self._run(v, imgs, poses, cp, 2, v)
        assert cc_minus > cc_plus + 0.01, (cc_minus, cc_plus)

    def test_reference_scale_is_fitted(self, vol, monkeypatch):
        """A reference 37 times off the particles' scale (a normalized
        stack, an outside map) gives what the reference on the particles'
        scale inserted unscaled gives, and beats the unscaled one."""
        imgs, poses, cp = self._split_data(vol, +1)

        def run(ref):
            out = trec.reconstruct(imgs, poses, cp, PIXEL, voltage_kv=VOLTAGE,
                                   iewald=2, wiener=0.2, ref_volume=ref,
                                   device="cpu")
            return out.volume.numpy()

        fitted = run(37.0 * vol)
        monkeypatch.setattr(tfs, "ref_amplitude",
                            lambda pred, F: torch.ones(F.shape[0]))
        exact, off = run(vol), run(37.0 * vol)
        assert _cc(fitted, exact) > 0.999, _cc(fitted, exact)
        assert _cc(fitted, vol) > _cc(off, vol) + 0.1, (_cc(fitted, vol), _cc(off, vol))

    def test_fitted_insertion_is_the_jax_insertion_of_the_scaled_reference(self, vol):
        """The port's fitted IEWALD-2 insertion of each particle equals the
        JAX insertion of that particle with the reference times a_i, the
        least-squares amplitude of the reference's predicted image, computed
        here from JAX's gathers (a 37x reference and noisy particles)."""
        B, c = 8, curvature()
        imgs, poses, cp = self._split_data(vol, +1, n=B, seed=11)
        imgs = imgs + 0.2 * imgs.std() * np.random.RandomState(12).randn(
            *imgs.shape).astype(np.float32)
        chi = np.asarray(jrec._chi_grids(N, PIXEL, jnp.asarray(cp), VOLTAGE, 2.7, 0.07))
        Rj = j_e2m(*(jnp.asarray(poses[:, k]) for k in range(3)))
        Fj = jfs.image_to_fourier(jnp.asarray(imgs))
        ref_j = jfs.volume_to_fourier(jnp.asarray(37.0 * vol), 2)
        ky = np.fft.fftfreq(N) * N
        g2 = (ky[:, None] ** 2 + np.arange(N // 2 + 1)[None, :] ** 2).astype(np.float32)
        curve = c * g2[None, :, :, None] * np.asarray(Rj)[:, 2, ::-1][:, None, None, :]
        q = np.asarray(jfs.slice_coords(Rj, N))
        Rp = np.asarray(jfs.gather_3d_hermitian(ref_j, jnp.asarray(q + curve), scale=2.0))
        Rm = np.asarray(jfs.gather_3d_hermitian(ref_j, jnp.asarray(-q + curve), scale=2.0))
        ctfp = 0.5j * np.exp(1j * chi)
        pred = ctfp * Rp + np.conj(ctfp) * np.conj(Rm)
        a = np.maximum(np.sum((np.conj(pred) * np.asarray(Fj)).real, (1, 2))
                       / np.sum(np.abs(pred) ** 2, (1, 2)), 0.0)
        assert np.all(a > 0.01) and np.all(a < 0.1), a
        sub, w = np.arange(B) % 2, np.ones(B, np.float32)
        want = [0.0] * 4
        for i in range(B):
            parts = jfs.insert_slices_halves(
                Fj[i:i + 1], jnp.ones((1, N, N // 2 + 1)), Rj[i:i + 1],
                jnp.asarray(sub[i:i + 1]), jnp.asarray(w[i:i + 1]), N,
                ewald_c=c, ref_fourier=ref_j * a[i], chi=jnp.asarray(chi[i:i + 1]))
            want = [x + np.asarray(y) for x, y in zip(want, parts)]
        out = tfs.insert_slices_halves(
            tfs.image_to_fourier(t(imgs)), torch.ones((B, N, N // 2 + 1)), t(Rj),
            t(sub), t(w), N, ewald_c=c, ref_fourier=t(ref_j), chi=t(chi))
        for o, r in zip(out, want):
            close(o, r, mask=inside_nyquist(2 * N))

    def test_iewald2_without_reference_degrades_to_simple(self, vol):
        imgs, poses, cp = self._split_data(vol, +1, n=16)
        a = trec.reconstruct(imgs, poses, cp, PIXEL, voltage_kv=VOLTAGE,
                             iewald=2, wiener=0.2, device="cpu")
        b = trec.reconstruct(imgs, poses, cp, PIXEL, voltage_kv=VOLTAGE,
                             iewald=1, wiener=0.2, device="cpu")
        assert torch.isfinite(a.volume).all()
        np.testing.assert_allclose(a.volume.numpy(), b.volume.numpy(), atol=1e-5)


class TestLikelihoodBlurring:
    @pytest.mark.parametrize("nrot,rng_deg", [(21, 20.0), (5, 12.0), (0, 20.0), (1, 4.0)])
    def test_bank(self, nrot, rng_deg):
        assert trec.lblur_bank(nrot, rng_deg) == jrec.lblur_bank(nrot, rng_deg)
        if nrot > 1:
            offs, w = trec.lblur_bank(nrot, rng_deg)
            np.testing.assert_allclose(np.sum(w), 1.0, rtol=1e-6)
            assert offs[0] == -rng_deg / 2 and w[nrot // 2] == max(w)

    def test_linearity_vs_explicit_offsets(self, particles):
        """accumulate(lblur=bank) == sum_k w_k * accumulate(psi + off_k)."""
        _, stack, cp, poses = particles
        sub, w = t(np.arange(12) % 2), torch.ones(12)
        bank = trec.lblur_bank(5, 12.0)
        blurred = trec.accumulate(t(stack), t(poses), t(cp), sub, w, N, PIXEL,
                                  lblur=bank)
        parts = []
        for off, rw in zip(*bank):
            p2 = poses.copy()
            p2[:, 2] += off
            parts.append(trec.accumulate(t(stack), t(p2), t(cp), sub,
                                         w * float(rw), N, PIXEL))
        for got, want in zip(blurred, trec.merge_accumulators(parts)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                       atol=1e-5)

    def test_blurred_reconstruction_stays_faithful(self):
        v = make_volume(seed=5)
        stack, cp, truth = make_particles(v, n_particles=96, seed=6)
        poses = np.stack([truth["phi"], truth["theta"], truth["psi"],
                          truth["shifts"][:, 1], truth["shifts"][:, 0]],
                         axis=1).astype(np.float32)
        sharp = trec.reconstruct(np.array(stack), poses, np.array(cp), PIXEL,
                                 device="cpu")
        blurred = trec.reconstruct(np.array(stack), poses, np.array(cp), PIXEL,
                                   lblur_nrot=5, lblur_range=4.0, device="cpu")
        cc_b, cc_s = _cc(blurred.volume, v), _cc(sharp.volume, v)
        assert cc_b > 0.8 * cc_s and cc_b > 0.3, (cc_b, cc_s)
