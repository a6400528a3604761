"""Parity of pyp_tpu_torch.ops.frm (the FRM engine) against pyp_tpu.ops.frm
on the CPU, at box 32 / 2 Å per pixel with the helpers of
tests/test_refine3d.py, plus the recovery checks of tests/test_frm.py run
on the port.

Tolerances:
  * host geometry (rings, psi count, polar points, W, FSC ring weights):
    bit-equal — both are the same numpy code;
  * ctf_2d: 5e-5 absolute (float32 phases of a few hundred radians);
  * polar transform, restoration (both samplers), the gather sampler's
    pieces, the bank tables, _roll_psi, _refine_shifts: max abs error at
    most 1e-5 x the reference's max abs value;
  * _match_core and the score matrix of frm_score_directions on the same
    inputs: the same indices, scores within 1e-5;
  * frm_refine end to end: >= 95% of poses equal to 1e-3 (° and px),
    scores within 1e-5 on those;
  * recovery against the truth: the bars of tests/test_frm.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_refine3d import N, PIXEL, make_particles, make_volume, rotation_error_deg

from pyp_tpu.ops import fourier_slice as jfs
from pyp_tpu.ops import frm as jf
from pyp_tpu_torch.core.geometry import euler_to_matrix
from pyp_tpu_torch.ops import fourier_slice as tfs
from pyp_tpu_torch.ops import frm as tf
from pyp_tpu_torch.ops import reconstruct as rec

CFG = dict(low_res=30.0, high_res=6.0, angular_step=11.0, shift_extent=3.0,
           shift_step=0.5)
# the port's FrmConfig defaults to the card: these tests run on the CPU
TCFG = dict(CFG, device="cpu")


def t(x):
    return torch.from_numpy(np.array(x))


def close(out, ref, rel=1e-5):
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=rel * float(np.abs(ref).max()))


def errs_to_truth(poses, truth):
    return np.array([rotation_error_deg(
        euler_to_matrix(*(float(v) for v in poses[b, :3])).numpy(),
        truth["R"][b]) for b in range(len(poses))])


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for this file's torch ops: several test
    workers share the machine's cores, and a thread per core in each of
    them oversubscribes the cores (this file: ~55 s alone, ~520 s in a
    six-worker run with one thread per core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem():
    vol = make_volume()
    stack, cp, truth = make_particles(vol, n_particles=16, noise=0.1)
    return vol, np.array(stack), np.array(cp), truth


@pytest.fixture(scope="module")
def geometry():
    radii = jf.make_rings(N, PIXEL, 30.0, 6.0)
    K = jf.default_n_psi(radii)
    return radii, K, jf.polar_points(radii, K), jf.ring_weights(radii), \
        jf.polar_matrix(N, radii, K)


class TestGeometry:
    @pytest.mark.parametrize("n,pixel,lo,hi", [(32, 2.0, 30.0, 6.0),
                                               (48, 1.5, 40.0, 4.0),
                                               (24, 1.0, 25.0, 3.0)])
    def test_polar_matrix_bit_equal(self, n, pixel, lo, hi):
        radii = tf.make_rings(n, pixel, lo, hi)
        np.testing.assert_array_equal(radii, jf.make_rings(n, pixel, lo, hi))
        K = tf.default_n_psi(radii)
        assert K == jf.default_n_psi(radii)
        np.testing.assert_array_equal(tf.ring_weights(radii),
                                      jf.ring_weights(radii))
        np.testing.assert_array_equal(tf.polar_points(radii, K),
                                      jf.polar_points(radii, K))
        for a, b in zip(tf.polar_matrix(n, radii, K),
                        jf.polar_matrix(n, radii, K)):
            np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("seed", [0, 1])
    def test_ring_weights_from_fsc_exact(self, seed):
        curve = np.sort(np.random.RandomState(seed).uniform(-0.1, 1, 64))[::-1]
        radii = tf.make_rings(128, 1.0, 50.0, 4.0)
        np.testing.assert_array_equal(
            tf.ring_weights_from_fsc(curve, radii, 128),
            jf.ring_weights_from_fsc(curve, radii, 128))

    def test_empty_band_raises(self):
        with pytest.raises(ValueError, match="empty band"):
            tf.make_rings(32, 2.0, 10.0, 20.0)


class TestPolarSampling:
    def test_polar_transform(self, problem, geometry):
        _, stack, _, _ = problem
        *_, (W_re, W_im) = geometry
        ref = jf.polar_transform(jnp.asarray(stack), jnp.asarray(W_re),
                                 jnp.asarray(W_im))
        close(tf.polar_transform(t(stack), t(W_re), t(W_im)), ref)
        close(tf.image_to_fourier_full(t(stack)),
              jf.image_to_fourier_full(jnp.asarray(stack)))

    @pytest.mark.parametrize("gather", [False, True])
    def test_restore_polar(self, problem, geometry, gather):
        _, stack, cp, _ = problem
        radii, K, pts, rw, (W_re, W_im) = geometry
        args = (N, K, PIXEL, 300.0, 2.7, 0.07, 0.1, gather)
        Xj, wj = jf._restore_polar(jnp.asarray(stack), jnp.asarray(cp),
                                   jnp.asarray(W_re), jnp.asarray(W_im),
                                   jnp.asarray(pts), jnp.asarray(rw), *args)
        Xt, wt = tf._restore_polar(t(stack), t(cp), t(W_re), t(W_im), t(pts),
                                   t(rw), *args)
        close(Xt, Xj)
        close(wt, wj)

    def test_polar_sample_gather(self, problem, geometry):
        _, stack, cp, _ = problem
        radii, K, pts, _, _ = geometry
        Yj = jf._oversampled_spectra(jnp.asarray(stack), 2)
        Yt = tf._oversampled_spectra(t(stack), 2)
        close(Yt, Yj)
        # points off the grid on both sides of zero: the wrap is floor-mod
        p = np.asarray(pts) * 2.0 + np.float32(0.37)
        close(tf._bicubic_wrap_take(Yt, t(p)),
              jf._bicubic_wrap_take(Yj, jnp.asarray(p)))
        Xj, cj = jf.polar_sample_gather(jnp.asarray(stack), jnp.asarray(cp),
                                        jnp.asarray(pts), N, PIXEL, 300.0,
                                        2.7, 0.07, 0.1)
        Xt, ct = tf.polar_sample_gather(t(stack), t(cp), t(pts), N, PIXEL,
                                        300.0, 2.7, 0.07, 0.1)
        close(Xt, Xj)
        close(ct, cj)

    def test_ctf_2d(self):
        from pyp_tpu.core import ctf as jctf
        from pyp_tpu_torch.core import ctf as tctf

        df1 = np.array([15000.0, 22000.0], np.float32)
        for rfft in (True, False):
            kw = dict(w=0.1, phase_shift_rad=np.float32(0.3), rfft=rfft)
            ref = jctf.ctf_2d((N, N), PIXEL, jnp.asarray(df1),
                              jnp.asarray(df1 - 700), 30.0, 300.0, 2.7, **kw)
            out = tctf.ctf_2d((N, N), PIXEL, t(df1), t(df1 - 700), 30.0,
                              300.0, 2.7, **kw)
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-5)

    def test_shift_phasor(self, geometry):
        _, _, pts, _, _ = geometry
        sh = np.random.RandomState(2).uniform(-3, 3, (5, 2)).astype(np.float32)
        close(tf.shift_phasor_polar(t(pts), t(sh), N),
              jf.shift_phasor_polar(jnp.asarray(pts), jnp.asarray(sh), N))


class TestBank:
    def test_bank_tables(self, problem, geometry):
        vol = problem[0]
        radii, K, pts, _, _ = geometry
        dirs = jf.FrmConfig(N, PIXEL, **CFG).directions
        Fj = jfs.volume_to_fourier(jnp.asarray(vol))
        Ft = tfs.volume_to_fourier(t(vol))
        FUj, u2j = jf._bank_tables(Fj, jnp.asarray(dirs), jnp.asarray(pts), N)
        FUt, u2t = tf._bank_tables(Ft, t(dirs), t(pts), N)
        assert dirs.shape[0] > tf._BANK_BLOCK  # more than one block
        close(FUt, FUj)
        close(u2t, u2j)
        close(tf.direction_bank(Ft, dirs[:40], radii, K, N),
              jf.direction_bank(Fj, dirs[:40], radii, K, N))
        bj = jf.FrmBank(Fj, dirs, radii, K, N)
        bt = tf.FrmBank(Ft, dirs, radii, K, N)
        np.testing.assert_allclose(bt.axes, bj.axes, atol=1e-6)

    def test_roll_psi(self):
        rng = np.random.RandomState(5)
        U = (rng.randn(4, 3, 64) + 1j * rng.randn(4, 3, 64)).astype(np.complex64)
        psi = rng.uniform(0, 360, 4).astype(np.float32)
        close(tf._roll_psi(t(U), t(psi)), jf._roll_psi(jnp.asarray(U),
                                                      jnp.asarray(psi)))


def _match_inputs(seed=0, S=3, B=6, R=5, K=32, D=37):
    rng = np.random.RandomState(seed)

    def c(*shape):
        return (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)

    FA = c(S, B, R, K)
    FUc = c(D, R, K)
    ring_w = rng.uniform(0.1, 1, (B, R)).astype(np.float32)
    u2 = rng.uniform(1, 2, (D, R)).astype(np.float32)
    xnorm2 = rng.uniform(1, 2, B).astype(np.float32)
    return FA, FUc, ring_w, u2, xnorm2


class TestMatch:
    @pytest.mark.parametrize("upsample,d_block,local", [(4, 8, False),
                                                        (1, 16, True),
                                                        (4, 40, True)])
    def test_match_core(self, upsample, d_block, local):
        FA, FUc, ring_w, u2, xnorm2 = _match_inputs()
        B, D, K = FA.shape[1], FUc.shape[0], FA.shape[-1]
        pad = (-D) % d_block
        rng = np.random.RandomState(1)
        mask = np.zeros((B, D + pad), np.float32)
        mask[:, D:] = -np.inf
        psi_mask = None
        if local:
            mask[:, :D][rng.rand(B, D) < 0.7] = -np.inf
            mask[0, :] = -np.inf  # a cone with no direction -> index 0
            psi_mask = np.where(rng.rand(B, K * upsample) < 0.5, 0.0,
                                -np.inf).astype(np.float32)
        FUp = np.pad(FUc, ((0, pad), (0, 0), (0, 0)))
        u2p = np.pad(u2, ((0, pad), (0, 0)))
        ref = jf._match_core(jnp.asarray(FA), jnp.asarray(xnorm2),
                             jnp.asarray(ring_w), jnp.asarray(FUp),
                             jnp.asarray(u2p), jnp.asarray(mask), d_block,
                             upsample, None if psi_mask is None
                             else jnp.asarray(psi_mask))
        out = tf._match_core(t(FA), t(xnorm2), t(ring_w), t(FUp), t(u2p),
                             t(mask), d_block, upsample,
                             None if psi_mask is None else t(psi_mask))
        for a, b in zip(out[1:], ref[1:]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]),
                                   atol=1e-5)
        if local:
            assert out[0][0] == -np.inf
            assert [int(x[0]) for x in out[1:]] == [0, 0, 0]

    def test_num_hat_rounds_inputs_to_bf16(self):
        FA, FUc, *_ = _match_inputs(seed=3)
        close(tf._num_hat(t(FA[0]), t(FUc)),
              jf._num_hat(jnp.asarray(FA[0]), jnp.asarray(FUc)), rel=1e-6)
        for up in (1, 4):
            h = np.asarray(jf._num_hat(jnp.asarray(FA[0]), jnp.asarray(FUc)))
            close(tf._upsampled_ifft(t(h), up),
                  jf._upsampled_ifft(jnp.asarray(h), up))

    def test_refine_shifts(self, geometry):
        radii, K, pts, rw, _ = geometry
        rng = np.random.RandomState(4)
        B, R = 5, len(radii)
        Xp = (rng.randn(B, R, K) + 1j * rng.randn(B, R, K)).astype(np.complex64)
        U = (rng.randn(B, R, K) + 1j * rng.randn(B, R, K)).astype(np.complex64)
        w = rng.uniform(0.1, 1, (B, R)).astype(np.float32)
        u2 = (np.abs(U) ** 2).sum(-1).astype(np.float32)
        psi = rng.uniform(0, 360, B).astype(np.float32)
        from pyp_tpu_torch.ops.refine3d import make_shift_grid

        grids = (make_shift_grid(2.0, 0.5)[None]
                 + rng.uniform(-1, 1, (B, 1, 2))).astype(np.float32)
        ref = jf._refine_shifts(jnp.asarray(Xp), jnp.asarray(w),
                                jnp.asarray(U), jnp.asarray(u2),
                                jnp.asarray(psi), jnp.asarray(pts),
                                jnp.asarray(grids), N)
        out = tf._refine_shifts(t(Xp), t(w), t(U), t(u2), t(psi), t(pts),
                                t(grids), N)
        np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]),
                                   atol=1e-5)

    @pytest.mark.parametrize("marginalize", [False, True])
    def test_frm_score_directions(self, problem, marginalize):
        vol, stack, cp, truth = problem
        shifts = -truth["shifts"] if not marginalize else None
        cj = jf.FrmConfig(N, PIXEL, **CFG)
        ct = tf.FrmConfig(N, PIXEL, **TCFG)
        bj = cj.bank(jfs.volume_to_fourier(jnp.asarray(vol)))
        bt = ct.bank(tfs.volume_to_fourier(t(vol)))
        ref = jf.frm_score_directions(jnp.asarray(stack), jnp.asarray(cp), cj,
                                      bj, shifts=shifts, d_block=64,
                                      marginalize_shifts=marginalize)
        out = tf.frm_score_directions(t(stack), t(cp), ct, bt, shifts=shifts,
                                      d_block=64,
                                      marginalize_shifts=marginalize)
        np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]),
                                   atol=1e-5)
        assert np.mean(out[1].numpy() == np.asarray(ref[1])) >= 0.99
        assert np.mean(np.all(out[2].numpy() == np.asarray(ref[2]), -1)) >= 0.99
        assert out[2].shape == (16, len(ct.directions), 2)

    def test_to_refine_result(self):
        rng = np.random.RandomState(6)
        poses = rng.uniform(-400, 400, (9, 5)).astype(np.float32)
        scores = rng.uniform(-1.2, 1.2, 9).astype(np.float32)
        ref = jf.to_refine_result(jnp.asarray(poses), jnp.asarray(scores), 700)
        out = tf.to_refine_result(t(poses), t(scores), 700)
        for f in ref._fields:
            np.testing.assert_allclose(getattr(out, f).numpy(),
                                       np.asarray(getattr(ref, f)),
                                       rtol=1e-6, atol=1e-4, err_msg=f)
        assert (out.phi.numpy() >= 0).all() and (out.phi.numpy() < 360).all()


class TestFrmRefine:
    @pytest.mark.parametrize("mode,local", [("matmul", False),
                                            ("matmul", True),
                                            ("gather", False)])
    def test_same_as_jax(self, problem, monkeypatch, mode, local):
        vol, stack, cp, truth = problem
        monkeypatch.setenv("PYP_TPU_FRM_POLAR", mode)
        cj = jf.FrmConfig(N, PIXEL, **CFG)
        ct = tf.FrmConfig(N, PIXEL, **TCFG)
        assert ct.polar_gather == cj.polar_gather == (mode == "gather")
        init = cone = None
        if local:
            init = np.stack([truth["phi"] + 3, truth["theta"] - 2,
                             truth["psi"] + 2, -truth["shifts"][:, 0],
                             -truth["shifts"][:, 1]], 1).astype(np.float32)
            cone = 10.0
        curve = np.linspace(1.0, 0.2, N // 2)
        pj, sj = jf.frm_refine(jnp.asarray(stack), jnp.asarray(cp),
                               jfs.volume_to_fourier(jnp.asarray(vol)), cj,
                               init_poses=init, prior_cone_deg=cone,
                               fsc_curve=curve)
        pt, st = tf.frm_refine(t(stack), t(cp), tfs.volume_to_fourier(t(vol)),
                               ct, init_poses=init, prior_cone_deg=cone,
                               fsc_curve=curve)
        same = np.all(np.abs(pt.numpy() - np.asarray(pj)) < 1e-3, axis=1)
        assert same.mean() >= 0.95, pt.numpy() - np.asarray(pj)
        np.testing.assert_allclose(st.numpy()[same], np.asarray(sj)[same],
                                   atol=1e-5)

    def test_d_block_does_not_change_results(self, problem):
        vol, stack, cp, _ = problem
        cfg = tf.FrmConfig(N, PIXEL, **TCFG)
        bank = cfg.bank(tfs.volume_to_fourier(t(vol)))
        D = bank.FUc.shape[0]
        outs = [tf.frm_refine(t(stack), t(cp), None, cfg, bank=bank,
                              d_block=db) for db in (8, 24, D)]
        for p, s in outs[1:]:
            np.testing.assert_array_equal(p.numpy(), outs[0][0].numpy())
            np.testing.assert_allclose(s.numpy(), outs[0][1].numpy(),
                                       atol=1e-6)
        assert tf.default_d_block(16, D, cfg.n_psi, cfg.upsample, "cpu") == 64


class TestRecovery:
    """The port recovers the truth as tests/test_frm.py requires of the
    JAX engine."""

    def test_global_recovery(self, problem):
        vol, stack, cp, truth = problem
        cfg = tf.FrmConfig(N, PIXEL, **TCFG)
        poses, _ = tf.frm_refine(t(stack), t(cp), tfs.volume_to_fourier(t(vol)),
                                 cfg)
        poses = poses.numpy()
        errs = errs_to_truth(poses, truth)
        # the stored shift is the centering translation (= -content offset)
        shift_errs = np.abs(poses[:, 3:5] + truth["shifts"]).max(1)
        assert np.median(errs) < 9.0, errs
        assert (errs < 14.0).mean() >= 0.8, errs
        assert np.median(shift_errs) < 1.0, shift_errs

    def test_local_mode_prior(self, problem):
        vol, stack, cp, truth = problem
        cfg = tf.FrmConfig(N, PIXEL, **dict(TCFG, angular_step=6.0))
        init = np.stack([truth["phi"], truth["theta"], truth["psi"],
                         np.zeros(16), np.zeros(16)], 1).astype(np.float32)
        poses, _ = tf.frm_refine(t(stack), t(cp), tfs.volume_to_fourier(t(vol)),
                                 cfg, init_poses=init, prior_cone_deg=10.0)
        assert np.median(errs_to_truth(poses.numpy(), truth)) < 7.0

    def test_large_box_autocrops_and_recovers(self):
        """A 64-px box searched to 9 Å crops internally and still recovers
        poses and shifts in data pixels."""
        from pyp_tpu_torch.core.filters import lowpass_filter_3d, soft_spherical_mask

        n, pixel, B = 64, 1.5, 8
        rng = np.random.RandomState(4)
        vol = torch.from_numpy(rng.randn(n, n, n).astype(np.float32))
        vol = vol * soft_spherical_mask(n, n * 0.35, 3.0)
        vol = lowpass_filter_3d(vol, pixel, 3.0 * pixel) * 10
        phi = rng.uniform(0, 360, B).astype(np.float32)
        theta = np.degrees(np.arccos(rng.uniform(-1, 1, B))).astype(np.float32)
        psi = rng.uniform(0, 360, B).astype(np.float32)
        shifts = rng.uniform(-3, 3, (B, 2)).astype(np.float32)
        df = rng.uniform(12000, 22000, B).astype(np.float32)
        cp = np.stack([df, df, np.zeros(B), np.zeros(B)], 1).astype(np.float32)
        Fv = tfs.volume_to_fourier(vol)
        R = euler_to_matrix(t(phi), t(theta), t(psi))
        F = rec._shift_correct(
            tfs.project(Fv, R, n) * rec._ctf_grids(n, pixel, t(cp), 300.0,
                                                   2.7, 0.07), t(shifts), n)
        imgs = tfs.fourier_to_image(F, n).numpy()
        imgs += 0.05 * np.abs(imgs).max() * rng.randn(*imgs.shape).astype(
            np.float32)
        cfg = tf.FrmConfig(n, pixel, low_res=40.0, high_res=9.0,
                           angular_step=11.0, shift_extent=4.0,
                           shift_step=0.5, rounds=2, device="cpu")
        assert cfg.n < n, (cfg.n, n)  # the crop engaged
        poses, _ = tf.frm_refine(t(imgs), t(cp), Fv, cfg)
        poses = poses.numpy()
        errs = [rotation_error_deg(
            euler_to_matrix(*(float(v) for v in poses[b, :3])).numpy(),
            R[b].numpy()) for b in range(B)]
        assert np.median(errs) < 9.0, errs
        assert np.median(np.abs(poses[:, 3:5] + shifts).max(1)) < 1.0

    def test_cross_engine_poses_reconstruct_directly(self):
        """FRM poses fed straight into reconstruct must center the
        particles: this pins the shift sign at the public surface."""
        vol = make_volume()
        stack, cp, _ = make_particles(vol, n_particles=48, noise=0.05,
                                      shift_max=3.0)
        cfg = tf.FrmConfig(N, PIXEL, low_res=30.0, high_res=6.0,
                           angular_step=10.0, shift_extent=4.0,
                           shift_step=0.5, rounds=3, device="cpu")
        poses, _ = tf.frm_refine(t(stack), t(cp), tfs.volume_to_fourier(t(vol)),
                                 cfg)
        out = rec.reconstruct(np.array(stack), poses, np.array(cp), PIXEL,
                            device="cpu")
        cc = np.corrcoef(out.volume.numpy().ravel(), vol.ravel())[0, 1]
        assert cc > 0.6, cc
        flipped = torch.cat([poses[:, :3], -poses[:, 3:]], 1)
        out_f = rec.reconstruct(np.array(stack), flipped, np.array(cp),
                              PIXEL, device="cpu")
        assert cc > np.corrcoef(out_f.volume.numpy().ravel(), vol.ravel())[0, 1]

    def test_gather_mode_recovery_parity(self, problem, monkeypatch):
        vol, stack, cp, truth = problem
        meds = {}
        for mode in ("matmul", "gather"):
            monkeypatch.setenv("PYP_TPU_FRM_POLAR", mode)
            cfg = tf.get_config(N, PIXEL, **TCFG)
            assert cfg.polar_gather == (mode == "gather")
            poses, _ = tf.frm_refine(t(stack), t(cp),
                                     tfs.volume_to_fourier(t(vol)), cfg)
            meds[mode] = float(np.median(errs_to_truth(poses.numpy(), truth)))
        assert meds["gather"] <= meds["matmul"] + 5.5, meds



def test_tf32_switch_holds_across_overlapping_threads():
    """`_fp32_matmul` on two threads whose entries overlap (A enters, B
    enters, A leaves while B is inside): TF32 stays off for every thread
    inside, and the setting from before the first entry comes back after
    the last exit."""
    import threading

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    seen = []
    a_in, b_in, a_out = (threading.Event() for _ in range(3))

    def a():
        with tf._fp32_matmul():
            a_in.set()
            b_in.wait(5)
            seen.append(("a", torch.backends.cuda.matmul.allow_tf32))
        a_out.set()

    def b():
        a_in.wait(5)
        with tf._fp32_matmul():
            b_in.set()
            a_out.wait(5)
            seen.append(("b", torch.backends.cuda.matmul.allow_tf32))

    try:
        threads = [threading.Thread(target=f) for f in (a, b)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(10)
        assert sorted(seen) == [("a", False), ("b", False)]
        assert torch.backends.cuda.matmul.allow_tf32 is True
        assert tf._tf32_entries == 0
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
