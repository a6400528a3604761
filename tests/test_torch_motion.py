"""Parity of pyp_tpu_torch.ops.motion against pyp_tpu.ops.motion on the
CPU: the same seeded numpy movie (12 frames of 128², a planted smooth
drift) goes through the JAX function and its torch port.

Tolerances: shifts within 1e-3 px (both packages take the same peak of the
same correlation surface; float32 FFT sums differ in order), averages and
other images rtol 1e-4 with atol 1e-4 * max|reference|, small dense
helpers 1e-5. Recovery tests hold the port alone to the planted drift, so
a mistake shared by both packages cannot pass.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyp_tpu.ops import motion as jm
from pyp_tpu_torch.ops import motion as tm


def close(port, ref, rtol=1e-4, atol_rel=1e-4):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    atol = atol_rel * max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol)


def make_movie(n_frames=12, n=128, drift_scale=6.0, noise=0.5, seed=0):
    """A band-limited random image shifted along an exponential +
    quadratic trajectory (zero mean), plus white noise; numpy only."""
    rng = np.random.RandomState(seed)
    fy = np.fft.fftfreq(n)[:, None]
    fx = np.fft.rfftfreq(n)[None, :]
    keep = np.sqrt(fy ** 2 + fx ** 2) < 0.25
    base = np.fft.irfft2(np.fft.rfft2(rng.randn(n, n)) * keep, s=(n, n)) * 10
    t = np.linspace(0, 1, n_frames)
    traj = np.stack([drift_scale * (1 - np.exp(-3 * t)),
                     -0.6 * drift_scale * t ** 2], axis=1)
    traj -= traj.mean(axis=0, keepdims=True)
    ramp = np.exp(-2j * np.pi * (fy[None] * traj[:, 0, None, None]
                                 + fx[None] * traj[:, 1, None, None]))
    frames = np.fft.irfft2(np.fft.rfft2(base)[None] * ramp, s=(n, n))
    frames += noise * rng.randn(*frames.shape)
    return frames.astype(np.float32), traj.astype(np.float32), base.astype(np.float32)


@pytest.fixture(scope="module")
def movie():
    return make_movie()


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


ALIGN_CASES = {
    "default": dict(bfactor=200.0, search_radius=20.0),
    "middle": dict(bfactor=200.0, search_radius=20.0, ref="middle"),
    "phase_only": dict(bfactor=200.0, search_radius=20.0, phase_only=True),
    "tol": dict(bfactor=200.0, search_radius=20.0, tol=0.05),
    "band": dict(bfactor=500.0, low_res=60.0, high_res=4.0, max_iters=4,
                 smooth_order=2, center=False),
    "no_smooth": dict(bfactor=200.0, search_radius=6.0, smooth_order=0),
}


@pytest.mark.parametrize("case", sorted(ALIGN_CASES))
def test_align_movie(movie, case):
    frames = movie[0]
    kw = ALIGN_CASES[case]
    ref = jm.align_movie(jnp.asarray(frames), **kw)
    out = tm.align_movie(frames, device="cpu", **kw)
    np.testing.assert_allclose(out.shifts.numpy(), np.asarray(ref.shifts),
                               atol=1e-3)
    close(out.average, ref.average)
    assert abs(float(out.converged) - float(ref.converged)) < 1e-3


@pytest.mark.parametrize("ref_mode", ["average", "middle"])
def test_align_movie_recovers_planted_drift(movie, ref_mode):
    frames, traj, _ = movie
    out = tm.align_movie(frames, bfactor=200.0, search_radius=20.0,
                         ref=ref_mode, device="cpu")
    err = np.abs(out.shifts.numpy() + traj)
    assert err.max() < 0.35, err.max()


@pytest.mark.parametrize("binning", [1, 2])
@pytest.mark.parametrize("dose_weighted", [True, False])
def test_align_movie_large(movie, binning, dose_weighted):
    frames, traj, _ = movie
    doses = 0.5 + 1.2 * np.arange(1, len(frames) + 1, dtype=np.float32)
    ref = jm.align_movie_large(jnp.asarray(frames), pixel_size=1.2,
                               binning=binning, doses=jnp.asarray(doses),
                               dose_weighted=dose_weighted, bfactor=200.0)
    out = tm.align_movie_large(frames, pixel_size=1.2, binning=binning,
                               doses=doses, dose_weighted=dose_weighted,
                               bfactor=200.0, device="cpu")
    np.testing.assert_allclose(out.shifts.numpy(), np.asarray(ref.shifts),
                               atol=1e-3)
    close(out.average, ref.average)
    # and against the truth: binned alignment scales its shifts back
    assert np.abs(out.shifts.numpy() + traj).max() < 0.5


def test_align_movie_large_default_doses_and_kwargs(movie):
    frames = movie[0]
    kw = dict(binning=2, bfactor=300.0, max_iters=5, search_radius=12.0,
              smooth_order=2, ref="middle", low_res=80.0, high_res=3.0)
    ref = jm.align_movie_large(jnp.asarray(frames), **kw)
    out = tm.align_movie_large(frames, device="cpu", **kw)
    np.testing.assert_allclose(out.shifts.numpy(), np.asarray(ref.shifts),
                               atol=1e-3)
    close(out.average, ref.average)


def test_spectra_are_the_binned_and_full_transforms(movie):
    frames = movie[0]
    F_ref, Fs_ref = jm._spectra_scan(jnp.asarray(frames), 2)
    F, Fs = tm._spectra(torch.from_numpy(frames), 2)
    close(torch.view_as_real(F), np.stack([np.real(F_ref), np.imag(F_ref)], -1))
    close(torch.view_as_real(Fs), np.stack([np.real(Fs_ref), np.imag(Fs_ref)], -1))
    close(tm._bin_frames(torch.from_numpy(frames), 2),
          jm._bin_frames_scan(jnp.asarray(frames), 2))


@pytest.mark.parametrize("dose_weighted", [True, False])
def test_average_scans(movie, dose_weighted):
    frames, traj, _ = movie
    shifts = -traj
    doses = np.linspace(2.0, 30.0, len(frames)).astype(np.float32)
    ref = jm._average_scan(jnp.asarray(frames), jnp.asarray(shifts),
                           jnp.asarray(doses), 1.5, dose_weighted)
    out = tm._average_scan(torch.from_numpy(frames), torch.from_numpy(shifts),
                           doses, 1.5, dose_weighted)
    close(out, ref)
    F = torch.fft.rfft2(torch.from_numpy(frames))
    out2 = tm._average_spectra_scan(F, torch.from_numpy(shifts), doses,
                                    128, 128, 1.5, dose_weighted)
    ref2 = jm._average_spectra_scan(jnp.fft.rfft2(jnp.asarray(frames)),
                                    jnp.asarray(shifts), jnp.asarray(doses),
                                    128, 128, 1.5, dose_weighted)
    close(out2, ref2)


@pytest.mark.parametrize("dose_weighted", [True, False])
def test_average_scans_do_not_depend_on_the_chunk(movie, dose_weighted,
                                                  monkeypatch):
    """On a card the chunk follows the free memory, which other processes
    on the card change: every chunk gives the same bits."""
    frames, traj, _ = movie
    shifts = torch.from_numpy(-traj)
    doses = np.linspace(2.0, 30.0, len(frames)).astype(np.float32)
    F = torch.fft.rfft2(torch.from_numpy(frames))
    outs = []
    for step in (len(frames), 5, 1):
        monkeypatch.setattr(tm, "_fft_chunk", lambda *a, s=step: s)
        outs.append((tm._average_scan(torch.from_numpy(frames), shifts,
                                      doses, 1.5, dose_weighted),
                     tm._average_spectra_scan(F, shifts, doses, 128, 128,
                                              1.5, dose_weighted)))
    for scan, spectra in outs[1:]:
        assert torch.equal(scan, outs[0][0])
        assert torch.equal(spectra, outs[0][1])


def test_scan_average_normalization_differs_from_dose_weighted_average(movie):
    """The scan forms divide by sqrt(sum w²) floored at 1e-6;
    dose_weighted_average by the norm floored at 1e-8: equal where the
    weights are not tiny, and both as the JAX package has them."""
    frames, traj, _ = movie
    shifts = torch.from_numpy(-traj)
    doses = np.linspace(2.0, 30.0, len(frames)).astype(np.float32)
    ref = jm.dose_weighted_average(jnp.asarray(frames), jnp.asarray(-traj),
                                   jnp.asarray(doses), pixel_size=1.0)
    out = tm.dose_weighted_average(torch.from_numpy(frames), shifts,
                                   torch.from_numpy(doses), pixel_size=1.0)
    close(out, ref)
    scan = tm._average_scan(torch.from_numpy(frames), shifts, doses, 1.0, True)
    close(scan, ref, rtol=1e-3, atol_rel=1e-3)


def test_weight_filter_and_phase_ramp():
    for kw in (dict(bfactor=1500.0, low_res=0.0, high_res=0.0),
               dict(bfactor=300.0, low_res=50.0, high_res=4.0)):
        close(tm._weight_filter(48, 64, 1.3, **kw),
              jm._weight_filter(48, 64, 1.3, **kw), atol_rel=1e-6)
    sh = np.random.RandomState(0).uniform(-5, 5, (7, 2)).astype(np.float32)
    ref = jm._phase_ramp(jnp.asarray(sh), 48, 64)
    out = tm._phase_ramp(torch.from_numpy(sh), 48, 64)
    close(out.real, np.real(ref), atol_rel=1e-5)
    close(out.imag, np.imag(ref), atol_rel=1e-5)


@pytest.mark.parametrize("shape", [(3, 32, 48), (2, 5, 33, 32)])
def test_subpixel_peak(shape):
    cc = np.random.RandomState(1).randn(*shape).astype(np.float32)
    close(tm._subpixel_peak(torch.from_numpy(cc)),
          jm._subpixel_peak(jnp.asarray(cc)), atol_rel=1e-6)


def test_subpixel_peak_win_and_zoom():
    rng = np.random.RandomState(2)
    cc = rng.randn(5, 64, 64).astype(np.float32)
    close(tm._subpixel_peak_win(torch.from_numpy(cc), 64),
          jm._subpixel_peak_win(jnp.asarray(cc), 64), atol_rel=1e-6)
    # the zoom DFT equals the window of the full irfft2
    ny, nx, W = 96, 80, 64
    img = rng.randn(3, ny, nx).astype(np.float32)
    S = torch.fft.rfft2(torch.from_numpy(img))
    Ay, Bx = tm._zoom_matrices(ny, nx, W)
    Ay_ref, Bx_ref = jm._zoom_matrices(ny, nx, W)
    np.testing.assert_array_equal(Ay.numpy(), np.asarray(Ay_ref))
    np.testing.assert_array_equal(Bx.numpy(), np.asarray(Bx_ref))
    cc_zoom = tm._zoom_cc(S, Ay, Bx)
    close(cc_zoom, jm._zoom_cc(jnp.asarray(S.numpy()), Ay_ref, Bx_ref))
    d = np.arange(W) - W // 2
    full = img[:, d % ny][:, :, d % nx] * (ny * nx)
    close(cc_zoom, full, rtol=1e-3, atol_rel=1e-4)


def test_align_spectra_zoom_and_irfft2_agree(movie):
    frames = torch.from_numpy(movie[0])
    Fw = torch.fft.rfft2(frames) * tm._weight_filter(128, 128, 1.0, 200.0, 0, 0)
    a, da = tm._align_spectra(Fw, 128, 128, search_radius=20.0, zoom=True)
    b, db = tm._align_spectra(Fw, 128, 128, search_radius=20.0, zoom=False)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-2)


@pytest.mark.parametrize("n,order", [(12, 3), (40, 3), (9, 1)])
def test_polyfit_smooth(n, order):
    sh = np.random.RandomState(n).randn(n, 2).astype(np.float32) * 3
    np.testing.assert_allclose(
        tm._polyfit_smooth(torch.from_numpy(sh), order).numpy(),
        np.asarray(jm._polyfit_smooth(jnp.asarray(sh), order)), atol=2e-5)


def test_extract_patches_and_running_average(movie):
    frames = movie[0][:, :100, :90]
    close(tm.extract_patches(torch.from_numpy(frames), (3, 2)),
          jm.extract_patches(jnp.asarray(frames), (3, 2)), atol_rel=0)
    for window in (3, 5):
        close(tm.running_average(torch.from_numpy(frames), window),
              jm.running_average(jnp.asarray(frames), window))


def test_weighted_average(movie):
    frames = movie[0]
    rng = np.random.RandomState(3)
    w1 = rng.uniform(0.5, 2.0, len(frames)).astype(np.float32)
    close(tm.weighted_average(torch.from_numpy(frames), w1),
          jm.weighted_average(jnp.asarray(frames), w1))
    w3 = rng.uniform(0, 1, (len(frames), 128, 65)).astype(np.float32)
    close(tm.weighted_average(torch.from_numpy(frames), w3),
          jm.weighted_average(jnp.asarray(frames), w3))


def test_align_movie_patches_and_local_shifts(movie):
    frames = movie[0]
    g_ref, ps_ref, c_ref = jm.align_movie_patches(
        jnp.asarray(frames), patch_grid=(2, 2), bfactor=200.0,
        search_radius=20.0)
    g, ps, c = tm.align_movie_patches(frames, patch_grid=(2, 2),
                                      bfactor=200.0, search_radius=20.0,
                                      device="cpu")
    np.testing.assert_allclose(g.shifts.numpy(), np.asarray(g_ref.shifts),
                               atol=1e-3)
    # patch shifts: peaks of noisier 64² correlations of frames shifted by
    # each package's own global result
    np.testing.assert_allclose(ps.numpy(), np.asarray(ps_ref), atol=5e-3)
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))
    pos = np.random.RandomState(4).uniform(0, 128, (9, 2)).astype(np.float32)
    rng = np.random.RandomState(5)
    shifts9 = rng.randn(9, 12, 2).astype(np.float32)
    centers9 = np.stack(np.meshgrid(np.arange(3) * 40 + 20.0,
                                    np.arange(3) * 40 + 20.0, indexing="ij"),
                        -1).reshape(-1, 2).astype(np.float32)
    out = tm.interpolate_local_shifts(torch.from_numpy(shifts9), centers9,
                                      pos, (128, 128), order=1)
    ref = jm.interpolate_local_shifts(jnp.asarray(shifts9),
                                      jnp.asarray(centers9), jnp.asarray(pos),
                                      (128, 128), order=1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4)


@pytest.mark.parametrize("major,minor,angle", [(1.02, 0.99, 30.0),
                                               (1.0, 1.0, 0.0),
                                               (0.97, 1.03, -75.0)])
def test_correct_mag_distortion(major, minor, angle):
    frames = np.random.RandomState(6).randn(3, 40, 56).astype(np.float32)
    close(tm.correct_mag_distortion(torch.from_numpy(frames), major, minor,
                                    angle),
          jm.correct_mag_distortion(jnp.asarray(frames), major, minor, angle),
          rtol=1e-3, atol_rel=1e-4)
