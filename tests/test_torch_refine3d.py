"""Parity of pyp_tpu_torch.ops.refine3d (the gather engine) against
pyp_tpu.ops.refine3d on the CPU, at box 32 / 2 Å per pixel with the
helpers of tests/test_refine3d.py.

Tolerances:
  * search geometry (directions, mask points, shift grid, shell weights):
    exact — both are the same numpy code;
  * global_search: the same (phi, theta, psi, shift) candidate on >= 95% of
    (particle, k) slots, compared as sets per particle because top-k may
    order exact ties differently; sorted top scores within 1e-4;
  * local_refine from one initial pose: >= 95% of particles within 0.05°
    and 0.01 px (24 momentum steps amplify last-bit differences only a
    little, since every step uses the normalized gradient);
  * refine_batch end to end: >= 90% of particles within 0.5° and 0.05 px,
    and on those, scores (100 * NCC) within 0.5;
  * refine_defocus: defocus within 0.5 Å, scores within 1e-5; and the
    recovery bar of tests/test_refine3d.py (mean error cut by 40%);
  * beam tilt: the phase field within 1e-5 x its max; estimated tilts
    within 1e-3 x the planted tilt (1e-7 rad at zero tilt); corrected
    images within 1e-5 x the max; and the recovery bars of
    tests/test_refine3d.py (30% of the planted tilt).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_refine3d import N, PIXEL, make_particles, make_volume

from pyp_tpu.core.geometry import euler_to_matrix as j_e2m
from pyp_tpu.ops import fourier_slice as jfs
from pyp_tpu.ops import refine3d as jr
from pyp_tpu_torch.ops import fourier_slice as tfs
from pyp_tpu_torch.ops import refine3d as tr

SEARCH = dict(angular_step=15.0, psi_step=10.0, low_res=100.0,
              high_res_search=3.0 * PIXEL, high_res_refine=2.5 * PIXEL,
              shift_extent=3.0, shift_step=1.5)


def t(x):
    return torch.from_numpy(np.array(x))


def rot_diff_deg(a, b):
    """Rotation angle between pose arrays (..., >=3) of (phi, theta, psi)."""
    Ra = np.asarray(j_e2m(jnp.asarray(a[..., 0]), jnp.asarray(a[..., 1]),
                          jnp.asarray(a[..., 2])))
    Rb = np.asarray(j_e2m(jnp.asarray(b[..., 0]), jnp.asarray(b[..., 1]),
                          jnp.asarray(b[..., 2])))
    tr_ = np.einsum("...ij,...ij->...", Ra, Rb)
    return np.degrees(np.arccos(np.clip((tr_ - 1) / 2, -1, 1)))


@pytest.fixture(scope="module")
def problem():
    vol = make_volume()
    imgs, ctf_params, truth = make_particles(vol, n_particles=12, noise=0.1)
    return vol, np.array(imgs), np.array(ctf_params), truth


class TestSearchGeometry:
    @pytest.mark.parametrize("step,sym", [(15.0, "C1"), (10.0, "C4"), (20.0, "D2")])
    def test_make_directions(self, step, sym):
        np.testing.assert_array_equal(tr.make_directions(step, sym),
                                      jr.make_directions(step, sym))

    def test_mask_points_shift_grid_weights(self):
        pts = tr.make_mask_points(N, PIXEL, 100.0, 5.0)
        np.testing.assert_array_equal(pts, jr.make_mask_points(N, PIXEL, 100.0, 5.0))
        np.testing.assert_array_equal(tr.make_shift_grid(3.0, 1.5),
                                      jr.make_shift_grid(3.0, 1.5))
        curve = np.linspace(1.0, 0.05, N // 2)
        np.testing.assert_array_equal(tr.shell_weights_from_fsc(curve, pts, N),
                                      jr.shell_weights_from_fsc(curve, pts, N))

    def test_ctf_phasors_focus(self):
        pts = jr.make_mask_points(N, PIXEL, 100.0, 5.0)
        ref = jr._ctf_at_points(jnp.asarray(pts), N, PIXEL, 15000.0, 14000.0,
                                30.0, 300.0, 2.7, 0.07, 0.2)
        out = tr._ctf_at_points(t(pts), N, PIXEL, 15000.0, 14000.0, 30.0,
                                300.0, 2.7, 0.07, 0.2)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
        sg = jr.make_shift_grid(3.0, 1.5)
        np.testing.assert_allclose(
            tr._shift_phasors(t(pts), t(sg), N).numpy(),
            np.asarray(jr._shift_phasors(jnp.asarray(pts), jnp.asarray(sg), N)),
            atol=1e-5)
        poses = np.random.RandomState(0).uniform(0, 90, (5, 5)).astype(np.float32)
        focus = jr.parse_focus_mask("10,-5,3,12")
        assert tr.parse_focus_mask("10:-5:3:12") == focus
        assert tr.parse_focus_mask("0,0,0,0") is None
        np.testing.assert_allclose(
            tr.focus_mask_2d(t(poses), focus, N, PIXEL).numpy(),
            np.asarray(jr.focus_mask_2d(poses, focus, N, PIXEL)), atol=1e-4)


class TestGlobalSearch:
    def test_candidates_match(self, problem):
        vol, imgs, cp, _ = problem
        directions = jr.make_directions(SEARCH["angular_step"])
        psis = np.arange(0.0, 360.0, SEARCH["psi_step"], dtype=np.float32)
        pts = jr.make_mask_points(N, PIXEL, SEARCH["low_res"], SEARCH["high_res_search"])
        sg = jr.make_shift_grid(SEARCH["shift_extent"], SEARCH["shift_step"])
        ref_pose, ref_sc = jr.global_search(
            jnp.asarray(imgs), jnp.asarray(cp), jfs.volume_to_fourier(jnp.asarray(vol)),
            jnp.asarray(directions), jnp.asarray(psis), jnp.asarray(pts),
            jnp.asarray(sg), N, PIXEL)
        pose, sc = tr.global_search(
            t(imgs), t(cp), tfs.volume_to_fourier(t(vol)), t(directions),
            t(psis), t(pts), t(sg), N, PIXEL)
        ref_pose, pose = np.asarray(ref_pose), pose.numpy()
        assert pose.shape == ref_pose.shape == (12, 4, 5)
        hits = [np.any(np.all(np.abs(ref_pose[b] - pose[b, k]) < 1e-3, axis=1))
                for b in range(12) for k in range(4)]
        assert np.mean(hits) >= 0.95, np.mean(hits)
        np.testing.assert_allclose(np.sort(sc.numpy(), 1),
                                   np.sort(np.asarray(ref_sc), 1), atol=1e-4)


class TestLocalRefine:
    @pytest.mark.parametrize("weighted", [False, True])
    def test_same_poses_from_one_init(self, problem, weighted):
        vol, imgs, cp, truth = problem
        rng = np.random.RandomState(3)
        init = np.stack([
            truth["phi"] + rng.uniform(-8, 8, 12),
            truth["theta"] + rng.uniform(-8, 8, 12),
            truth["psi"] + rng.uniform(-8, 8, 12),
            -truth["shifts"][:, 0] + rng.uniform(-1, 1, 12),
            -truth["shifts"][:, 1] + rng.uniform(-1, 1, 12),
        ], axis=1).astype(np.float32)
        pts = jr.make_mask_points(N, PIXEL, 100.0, 2.5 * PIXEL)
        w = (jr.shell_weights_from_fsc(np.linspace(1.0, 0.1, N // 2), pts, N)
             if weighted else None)
        ref_p, ref_s = jr.local_refine(
            jnp.asarray(imgs), jnp.asarray(cp), jfs.volume_to_fourier(jnp.asarray(vol)),
            jnp.asarray(init), jnp.asarray(pts), N, PIXEL,
            weights=None if w is None else jnp.asarray(w))
        p, s = tr.local_refine(t(imgs), t(cp), tfs.volume_to_fourier(t(vol)),
                               t(init), t(pts), N, PIXEL, weights=w)
        ref_p, p = np.asarray(ref_p), p.numpy()
        ang = np.abs(((p[:, :3] - ref_p[:, :3]) + 180.0) % 360.0 - 180.0).max(1)
        sh = np.abs(p[:, 3:] - ref_p[:, 3:]).max(1)
        assert np.mean((ang < 0.05) & (sh < 0.01)) >= 0.95, (ang, sh)
        np.testing.assert_allclose(s.numpy(), np.asarray(ref_s), atol=1e-4)
        assert np.all(s.numpy() >= tr.local_refine(
            t(imgs), t(cp), tfs.volume_to_fourier(t(vol)), t(init), t(pts), N,
            PIXEL, iters=0, weights=w)[1].numpy() - 1e-6)


class TestRefineBatch:
    @pytest.mark.parametrize("mode", ["global", "local"])
    def test_end_to_end(self, problem, mode):
        vol, imgs, cp, truth = problem
        init = None
        if mode == "local":
            init = np.stack([truth["phi"] + 3.0, truth["theta"] - 2.0,
                             truth["psi"] + 2.0, -truth["shifts"][:, 0],
                             -truth["shifts"][:, 1]], 1).astype(np.float32)
        kw = dict(SEARCH, mode=mode, init_poses=init, local_iters=30)
        ref = jr.refine_batch(jnp.asarray(imgs), jnp.asarray(cp), vol, PIXEL, **kw)
        out = tr.refine_batch(imgs, cp, vol, PIXEL, device="cpu", **kw)
        ref_p = np.stack([np.asarray(getattr(ref, f)) for f in ("phi", "theta", "psi", "shift_y", "shift_x")], 1)
        p = np.stack([getattr(out, f).numpy() for f in ("phi", "theta", "psi", "shift_y", "shift_x")], 1)
        ok = (rot_diff_deg(p, ref_p) < 0.5) & (np.abs(p[:, 3:] - ref_p[:, 3:]).max(1) < 0.05)
        assert ok.mean() >= 0.9, (rot_diff_deg(p, ref_p), p[:, 3:] - ref_p[:, 3:])
        # poses that agree to 0.5° score within 0.5 (score = 100 * NCC)
        np.testing.assert_allclose(out.score.numpy()[ok],
                                   np.asarray(ref.score)[ok], atol=0.5)
        np.testing.assert_allclose(out.sigma.numpy()[ok],
                                   np.asarray(ref.sigma)[ok], atol=0.01)
        # the search recovers the truth, as the JAX package's test asserts
        true_p = np.stack([truth["phi"], truth["theta"], truth["psi"]], 1)
        assert np.median(rot_diff_deg(p, true_p)) < 8.0


def _truth_poses(truth):
    return np.stack([truth["phi"], truth["theta"], truth["psi"],
                     -truth["shifts"][:, 0], -truth["shifts"][:, 1]],
                    1).astype(np.float32)


class TestRefineDefocus:
    def test_same_as_jax_and_recovers(self, problem):
        vol, imgs, cp, truth = problem
        derr = np.random.RandomState(11).uniform(-400, 400, 12).astype(np.float32)
        wrong = cp.copy()
        wrong[:, 0] += derr
        wrong[:, 1] += derr
        poses = _truth_poses(truth)
        pts = jr.make_mask_points(N, PIXEL, 100.0, 2.2 * PIXEL)
        ref_cp, ref_s = jr.refine_defocus(
            jnp.asarray(imgs), jnp.asarray(wrong),
            jfs.volume_to_fourier(jnp.asarray(vol)), jnp.asarray(poses),
            jnp.asarray(pts), N, PIXEL, search_range=600.0)
        out_cp, out_s = tr.refine_defocus(
            t(imgs), t(wrong), tfs.volume_to_fourier(t(vol)), t(poses), t(pts),
            N, PIXEL, search_range=600.0)
        np.testing.assert_allclose(out_cp.numpy(), np.asarray(ref_cp), atol=0.5)
        np.testing.assert_allclose(out_s.numpy(), np.asarray(ref_s), atol=1e-5)
        err_after = np.abs(out_cp.numpy()[:, 0] - cp[:, 0]).mean()
        assert err_after < 0.6 * np.abs(derr).mean(), err_after


class TestBeamTilt:
    T_TRUE = (4e-4, -2.5e-4)

    @pytest.fixture(scope="class")
    def tilted(self):
        vol = make_volume()
        stack, cp, truth = make_particles(vol, n_particles=24, noise=0.05,
                                          shift_max=0.0)
        poses = np.stack([truth["phi"], truth["theta"], truth["psi"],
                          truth["shifts"][:, 0], truth["shifts"][:, 1]],
                         1).astype(np.float32)
        ph = jr.beam_tilt_phase(N, PIXEL, *self.T_TRUE)
        X = jfs.image_to_fourier(stack)
        tilted = np.array(jfs.fourier_to_image(
            X * (jnp.cos(ph) + 1j * jnp.sin(ph)), N))
        return vol, np.array(stack), tilted, np.array(cp), poses

    def test_phase(self):
        ref = np.asarray(jr.beam_tilt_phase(N, PIXEL, 3e-4, -1e-4, 200.0, 2.0))
        out = tr.beam_tilt_phase(N, PIXEL, 3e-4, -1e-4, 200.0, 2.0).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max())

    @pytest.mark.parametrize("planted", [True, False])
    def test_estimate_same_as_jax(self, tilted, planted):
        vol, stack, tilt_stack, cp, poses = tilted
        imgs = tilt_stack if planted else stack
        kw = dict(low_res=40.0, high_res=2.5 * PIXEL)
        ref = jr.estimate_beam_tilt(jnp.asarray(imgs), jnp.asarray(cp),
                                    jfs.volume_to_fourier(jnp.asarray(vol)),
                                    jnp.asarray(poses), N, PIXEL, **kw)
        out = tr.estimate_beam_tilt(t(imgs), t(cp),
                                    tfs.volume_to_fourier(t(vol)), t(poses),
                                    N, PIXEL, batch=10, **kw)
        tol = 1e-3 * abs(self.T_TRUE[0]) if planted else 1e-7
        np.testing.assert_allclose([float(v) for v in out],
                                   [float(v) for v in ref], atol=tol)
        if planted:
            for got, want in zip(out, self.T_TRUE):
                assert abs(float(got) - want) < 0.3 * abs(want), (out, want)
        else:
            assert max(abs(float(v)) for v in out) < 1e-4

    def test_correct(self, tilted):
        _, stack, tilt_stack, _, _ = tilted
        ref = np.asarray(jr.correct_beam_tilt(tilt_stack, *self.T_TRUE, PIXEL))
        out = tr.correct_beam_tilt(t(tilt_stack), *self.T_TRUE, PIXEL).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max())
        assert np.abs(out - stack).mean() < 0.5 * np.abs(tilt_stack - stack).mean()
