"""Parity of pyp_tpu_torch/ops/tomo.py with pyp_tpu/ops/tomo.py on the
CPU: tilt-series alignment (stretch, cross-correlation, prealignment,
patch and bead tracking, the projection-model solves, fiducial
alignment), reconstruction (filters, WBP and its halves, forward and back
projection, SART) and the CTF steps (phase flipping, handedness,
deconvolution). The inputs are the JAX tests' own synthetic series
(`tests/test_tomo.make_tomo_data`, 13 tilts of 64², and
`make_fiducial_series`, 25 tilts of 192² with gold beads).

Tolerances: filters bit for bit; images and volumes rtol 1e-4 with atol
1e-4 * max|reference| (the port sums the tilts of a WBP block, and the z
planes of a forward projection, in another order than JAX's scans);
shifts and tracks within 2e-3 px; the host projection-model solves (the
same float64 numpy code) within 1e-6; integer results (handedness, the
picked defocus candidates) equal. The WBP of a thickness that is not a
multiple of the slab holds the port to `thickness` slices and compares
them with the first `thickness` of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyp_tpu.ops import tomo as jtomo
from pyp_tpu_torch.ops import tomo as ttomo
from tests.test_tomo import ANGLES, N, make_fiducial_series, make_tomo_data

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def close(port, ref, rtol=1e-4, atol_rel=1e-4):
    port = port.cpu().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    atol = atol_rel * max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def series():
    return make_tomo_data(noise=0.05)


@pytest.fixture(scope="module")
def fiducial():
    return make_fiducial_series()


@pytest.mark.parametrize("factor", [1.0, 0.8, 1.3, 2.5])
def test_stretch_x(factor):
    img = np.random.RandomState(0).randn(20, 33).astype(np.float32)
    close(ttomo._stretch_x(torch.from_numpy(img), factor),
          jtomo._stretch_x(jnp.asarray(img), factor), atol_rel=1e-6)


def test_stretch_x_batched_factors():
    rng = np.random.RandomState(1)
    imgs = rng.randn(3, 16, 24).astype(np.float32)
    f = [0.7, 1.0, 1.6]
    out = ttomo._stretch_x(torch.from_numpy(imgs), torch.tensor(f))
    for i in range(3):
        close(out[i], jtomo._stretch_x(jnp.asarray(imgs[i]), f[i]),
              atol_rel=1e-6)


def test_xcorr_shift(series):
    _, _, mis, _ = series
    a, b = mis[5:8], mis[6:9]
    close(ttomo._xcorr_shift(torch.from_numpy(a), torch.from_numpy(b)),
          jtomo._xcorr_shift(jnp.asarray(a), jnp.asarray(b)), atol_rel=2e-3)


@pytest.mark.parametrize("bp", [(0.01, 0.2), (0.05, 0.3)])
def test_prealign_tilt_series(series, bp):
    _, _, mis, true = series
    port = ttomo.prealign_tilt_series(mis, ANGLES, *bp, device=CPU)
    ref = np.asarray(jtomo.prealign_tilt_series(mis, ANGLES, *bp))
    assert isinstance(port, np.ndarray) and port.dtype == np.float32
    np.testing.assert_allclose(port, ref, atol=2e-3)
    assert np.median(np.abs(port - true)) < 1.0


def test_track_patches(series, monkeypatch):
    """The JAX package's tracker (every tilt against the zero tilt) is the
    reference here; the port's own, tilt to tilt, is held to the planted
    rotation below."""
    monkeypatch.setattr(ttomo, "TILT_TO_TILT", False)
    _, _, mis, _ = series
    shifts = np.asarray(jtomo.prealign_tilt_series(mis, ANGLES))
    centers = np.array([(y, x) for y in (20.0, 44.0) for x in (18.5, 40.0)],
                       np.float32)
    port = ttomo.track_patches(mis, shifts, ANGLES, centers, patch_size=24,
                               device=CPU)
    ref = np.asarray(jtomo.track_patches(mis, shifts, ANGLES, centers,
                                         patch_size=24))
    np.testing.assert_allclose(port, ref, atol=2e-3)


def _synthetic_tracks(seed=1, P=12, alpha=3.0):
    rng = np.random.RandomState(seed)
    pts = np.stack([rng.uniform(-10, 10, P), rng.uniform(-20, 20, P),
                    rng.uniform(-20, 20, P)], axis=1)
    pts -= pts.mean(axis=0, keepdims=True)
    th = np.radians(ANGLES)
    d_true = rng.uniform(-5, 5, (len(ANGLES), 2))
    ca, sa = np.cos(np.radians(alpha)), np.sin(np.radians(alpha))
    xr = pts[None, :, 2] * np.cos(th)[:, None] + pts[None, :, 0] * np.sin(th)[:, None]
    yr = np.broadcast_to(pts[None, :, 1], xr.shape)
    m = np.stack([sa * xr + ca * yr, ca * xr - sa * yr], axis=-1) - d_true[:, None]
    m = m + rng.randn(*m.shape) * 0.2 + N // 2
    m[3, 2] += 9.0                                   # one outlier
    return m, rng.uniform(0.3, 1.0, m.shape[:2])


def _model_close(a, b):
    for k in ("shifts", "axis_angle", "points3d", "residual"):
        np.testing.assert_allclose(np.asarray(getattr(a, k)),
                                   np.asarray(getattr(b, k)), atol=1e-6)


def test_solve_projection_model():
    m, _ = _synthetic_tracks()
    port = ttomo.solve_projection_model(m, ANGLES, (N, N))
    _model_close(port, jtomo.solve_projection_model(m, ANGLES, (N, N)))
    assert abs(float(port.axis_angle) - 3.0) < 0.5


@pytest.mark.parametrize("kw", [
    {}, {"use_conf": True}, {"tukey_factor": 0.5}, {"fixed_alpha": 2.0}],
    ids=["plain", "confidence", "tukey", "fixed_alpha"])
def test_solve_projection_model_robust(kw):
    m, conf = _synthetic_tracks(seed=2)
    kw = dict(kw)
    if kw.pop("use_conf", False):
        kw["confidence"] = conf
    pm, pw = ttomo.solve_projection_model_robust(m, ANGLES, (N, N), **kw)
    jm, jw = jtomo.solve_projection_model_robust(m, ANGLES, (N, N), **kw)
    _model_close(pm, jm)
    np.testing.assert_allclose(pw, np.asarray(jw), atol=1e-6)
    assert pw[3, 2] < 0.2 * pw.max()                # the outlier is dropped


@pytest.mark.parametrize("box,radius", [(32, 5.0), (48, 8.0)])
def test_bead_template(box, radius):
    close(ttomo._bead_template(box, radius), jtomo._bead_template(box, radius),
          rtol=0, atol_rel=0)


def test_track_beads(fiducial):
    tilts, angles, _, _, pos_true = fiducial
    shifts = np.asarray(jtomo.prealign_tilt_series(tilts, angles))
    ref_idx = int(np.argmin(np.abs(angles)))
    beads = pos_true[ref_idx][:6] + 0.3
    pm, pc = ttomo.track_beads(tilts, shifts, angles, beads, 5.0, device=CPU)
    jm, jc = jtomo.track_beads(tilts, shifts, angles, beads, 5.0)
    np.testing.assert_allclose(pm, np.asarray(jm), atol=2e-3)
    np.testing.assert_allclose(pc, np.asarray(jc), atol=1e-4)


def test_align_tilt_series_fiducial(fiducial):
    tilts, angles, _, d_true, _ = fiducial
    pm, pcoords, ptracks, pw = ttomo.align_tilt_series_fiducial(
        tilts, angles, bead_radius_px=5.0, max_beads=20, device=CPU)
    jm, jcoords, jtracks, jw = jtomo.align_tilt_series_fiducial(
        jnp.asarray(tilts), angles, bead_radius_px=5.0, max_beads=20)
    assert {tuple(c) for c in pcoords} == {tuple(c) for c in np.asarray(jcoords)}
    order = np.lexsort(pcoords.T[::-1])
    jorder = np.lexsort(np.asarray(jcoords).T[::-1])
    np.testing.assert_allclose(ptracks[:, order],
                               np.asarray(jtracks)[:, jorder], atol=2e-3)
    np.testing.assert_allclose(pw[:, order], np.asarray(jw)[:, jorder],
                               atol=1e-3)
    assert float(pm.axis_angle) == pytest.approx(float(jm.axis_angle))
    np.testing.assert_allclose(pm.shifts, np.asarray(jm.shifts), atol=2e-3)


def test_fiducial_alignment_raises_below_min_beads():
    tilts = np.zeros((5, 64, 64), np.float32)
    with pytest.raises(ValueError, match="gold beads"):
        ttomo.align_tilt_series_fiducial(tilts, np.linspace(-40, 40, 5),
                                         device=CPU)


@pytest.mark.parametrize("what", ["ramp", "ramp_cut", "sirt5", "sirt20",
                                  "shepp", "hamming", "hann", "none"])
def test_filters_are_exact(what):
    nx = 64
    if what.startswith("ramp"):
        args = (nx,) if what == "ramp" else (nx, 0.25, 0.1)
        p, j = ttomo.ramp_filter(*args), jtomo.ramp_filter(*args)
    elif what.startswith("sirt"):
        k = int(what[4:])
        p, j = ttomo.fake_sirt_filter(nx, k), jtomo.fake_sirt_filter(nx, k)
    else:
        p, j = ttomo.filter_window(nx, what), jtomo.filter_window(nx, what)
    np.testing.assert_array_equal(p.numpy(), np.asarray(j))


WBP_CASES = {
    "default": dict(thickness=N, slab=16),
    "fake_sirt": dict(thickness=32, slab=8, fake_sirt=10),
    "hamming": dict(thickness=32, slab=16, window="hamming", cutoff=0.3),
    "weights_zshift": dict(thickness=32, slab=16, z_shift=3.0),
}


@pytest.mark.parametrize("case", list(WBP_CASES))
def test_wbp_reconstruct(series, case):
    _, _, mis, true = series
    kw = dict(WBP_CASES[case])
    if case == "weights_zshift":
        kw["tilt_weights"] = np.cos(np.radians(ANGLES)).astype(np.float32)
    port = ttomo.wbp_reconstruct(mis, ANGLES, shifts=true, device=CPU, **kw)
    args = (jnp.asarray(mis), jnp.asarray(ANGLES))
    if kw.get("fake_sirt"):
        # the JAX package's jitted WBP cannot build its fake-SIRT filter
        # (np.asarray of a traced array); its eager path is the reference
        with pytest.raises(jax.errors.TracerArrayConversionError):
            jtomo.wbp_reconstruct(*args, shifts=jnp.asarray(true), **kw)
        with jax.disable_jit():
            ref = jtomo.wbp_reconstruct(*args, shifts=jnp.asarray(true), **kw)
    else:
        ref = jtomo.wbp_reconstruct(*args, shifts=jnp.asarray(true), **kw)
    close(port, ref)


def test_wbp_returns_exactly_thickness_slices(series):
    """JAX returns ceil(40 / 16) * 16 = 48 slices; the port returns 40,
    the first 40 of JAX's."""
    _, tilts, _, _ = series
    small = tilts[:, :32, :32]
    port = ttomo.wbp_reconstruct(small, ANGLES, thickness=40, slab=16,
                                 device=CPU)
    ref = np.asarray(jtomo.wbp_reconstruct(jnp.asarray(small),
                                           jnp.asarray(ANGLES),
                                           thickness=40, slab=16))
    assert ref.shape == (48, 32, 32)
    assert tuple(port.shape) == (40, 32, 32)
    close(port, ref[:40])


def test_wbp_small_blocks_change_nothing(series, monkeypatch):
    """A budget of a few (tilt, z) pairs splits the tilts and the slabs
    into many blocks; the result is the one-block result."""
    _, tilts, _, _ = series
    whole = ttomo.wbp_reconstruct(tilts, ANGLES, thickness=24, device=CPU)
    monkeypatch.setattr(ttomo, "rows_per_call",
                        lambda dev, total, per_row: 3)
    blocks = ttomo.wbp_reconstruct(tilts, ANGLES, thickness=24, device=CPU)
    close(blocks, whole.numpy(), rtol=1e-5, atol_rel=1e-6)


def test_wbp_reconstruct_halves(series):
    _, tilts, _, true = series
    ph = ttomo.wbp_reconstruct_halves(tilts, ANGLES, shifts=true,
                                      thickness=32, slab=16, device=CPU)
    jh = jtomo.wbp_reconstruct_halves(jnp.asarray(tilts), jnp.asarray(ANGLES),
                                      shifts=jnp.asarray(true), thickness=32,
                                      slab=16)
    for p, j in zip(ph, jh):
        close(p, j)


@pytest.mark.parametrize("angle", [-55.0, 0.0, 20.0])
def test_forward_and_back_projection(angle):
    rng = np.random.RandomState(4)
    vol = rng.randn(12, 16, 24).astype(np.float32)
    img = rng.randn(16, 24).astype(np.float32)
    a = np.float32(np.radians(angle))
    close(ttomo._forward_project(torch.from_numpy(vol), torch.tensor(a), 24),
          jtomo._forward_project(jnp.asarray(vol), jnp.asarray(a), 24))
    close(ttomo._backproject_one(torch.from_numpy(img), torch.tensor(a), 12,
                                 16, 24),
          jtomo._backproject_one(jnp.asarray(img), jnp.asarray(a), 12, 16, 24))


@pytest.mark.parametrize("kw", [dict(iterations=3, relax=0.25, subsets=4),
                                dict(iterations=2, relax=1.0, subsets=1)],
                         ids=["os4", "sirt"])
def test_sart_reconstruct(series, kw, monkeypatch):
    """With the JAX package's update (no floor on the ray length)."""
    monkeypatch.setattr(ttomo, "MIN_RAY_LENGTH", 0.0)
    _, _, mis, true = series
    small, sh = mis[:, 16:48, 16:48], true
    port = ttomo.sart_reconstruct(small, ANGLES, shifts=sh, thickness=16,
                                  device=CPU, **kw)
    ref = jtomo.sart_reconstruct(jnp.asarray(small), jnp.asarray(ANGLES),
                                 shifts=jnp.asarray(sh), thickness=16, **kw)
    close(port, ref, rtol=1e-3, atol_rel=1e-4)


@pytest.mark.parametrize("n_bands", [20, 7])
def test_ctf_correct_tilts(n_bands):
    rng = np.random.RandomState(3)
    tilts = rng.randn(3, 48, 64).astype(np.float32)
    angles, defoci = [35.0, -25.0, 0.0], [18000.0, 22000.0, 30000.0]
    port = ttomo.ctf_correct_tilts(tilts, angles, defoci, 2.0,
                                   n_bands=n_bands, device=CPU)
    ref = jtomo.ctf_correct_tilts(tilts, angles, defoci, 2.0, n_bands=n_bands)
    close(port, ref)


def test_ctf_correct_tilts_in_band_chunks(monkeypatch):
    """Bands flipped a few at a time (a small budget) give the
    all-bands-at-once result."""
    rng = np.random.RandomState(5)
    tilts = rng.randn(2, 32, 48).astype(np.float32)
    args = (tilts, [40.0, -10.0], [15000.0, 25000.0], 2.0)
    whole = ttomo.ctf_correct_tilts(*args, device=CPU)
    monkeypatch.setattr(ttomo, "rows_per_call",
                        lambda dev, total, per_row: 3)
    close(ttomo.ctf_correct_tilts(*args, device=CPU), whole.numpy(),
          rtol=0, atol_rel=0)


def _handed_tilts(sign, seed, angles, ny=256, nx=512, df0=20000.0):
    from pyp_tpu.core import ctf as cm

    rng = np.random.RandomState(seed)
    tilts = np.zeros((len(angles), ny, nx), dtype=np.float32)
    for t, theta in enumerate(angles):
        for half, sl in ((0, slice(0, nx // 2)), (1, slice(nx // 2, nx))):
            xc = (-nx / 4 if half == 0 else nx / 4)
            df = df0 + sign * xc * 2.0 * np.tan(np.radians(theta))
            noise = rng.randn(ny, nx // 2).astype(np.float32)
            c = np.asarray(cm.ctf_2d((ny, nx // 2), 2.0, df, df, 0.0, 300.0, 2.7))
            tilts[t][:, sl] = np.fft.irfft2(np.fft.rfft2(noise) * c,
                                            s=(ny, nx // 2))
    return tilts


@pytest.mark.parametrize("sign,angles", [(1, [-40.0, 30.0, 45.0, 10.0]),
                                         (-1, [40.0, -35.0])])
def test_detect_handedness(sign, angles):
    tilts = _handed_tilts(sign, 7 if sign > 0 else 8, angles)
    df = [20000.0] * len(angles)
    ph, pg = ttomo.detect_handedness(tilts, angles, df, 2.0, device=CPU)
    jh, jg = jtomo.detect_handedness(tilts, angles, df, 2.0)
    assert ph == jh == sign
    np.testing.assert_array_equal(pg, np.asarray(jg))


def test_half_defoci_pick_the_same_candidates():
    tilts = _handed_tilts(1, 9, [30.0, -50.0], ny=128, nx=256)
    halves = np.concatenate([tilts[:, :, :128], tilts[:, :, 128:]])
    df = np.full(4, 20000.0, np.float32)
    args = (128, 2.0, 300.0, 2.7, 0.07, 4000.0, 500.0, 30.0, 8.0)
    port = ttomo._half_defoci(torch.from_numpy(halves), torch.from_numpy(df),
                              *args)
    ref = jtomo._half_defoci_jit(jnp.asarray(halves), jnp.asarray(df), *args)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_handedness_without_tilts_in_range():
    tilts = np.zeros((2, 32, 64), np.float32)
    assert ttomo.detect_handedness(tilts, [5.0, -5.0], [2e4, 2e4], 2.0,
                                   device=CPU)[0] == 0


@pytest.mark.parametrize("shape,flipped", [((16, 24, 32), False),
                                           ((16, 24, 32), True),
                                           ((40, 48), False)])
def test_ctf_deconvolve(shape, flipped):
    vol = np.random.RandomState(6).randn(*shape).astype(np.float32)
    kw = dict(snr_falloff=0.8, deconv_strength=1.2, phase_flipped=flipped)
    close(ttomo.ctf_deconvolve(vol, 25000.0, 4.0, device=CPU, **kw),
          jtomo.ctf_deconvolve(vol, 25000.0, 4.0, **kw))


def test_sart_ray_floor_keeps_the_corners_bounded(series, monkeypatch):
    """In a slab thinner than the image is wide, rays that clip a corner
    carry tiny lengths; the JAX update divides their residual by that
    length and the corner voxels grow without bound. The port floors the
    length at one voxel."""
    vol, _, mis, true = series
    kw = dict(shifts=true, thickness=32, iterations=5, device=CPU)
    floor = ttomo.sart_reconstruct(mis, ANGLES, **kw).numpy()
    monkeypatch.setattr(ttomo, "MIN_RAY_LENGTH", 0.0)
    raw = ttomo.sart_reconstruct(mis, ANGLES, **kw).numpy()
    assert np.abs(floor).max() < 0.01 * np.abs(raw).max()
    sl, vsl = slice(10, 22), slice(N // 2 - 6, N // 2 + 6)
    cc = np.corrcoef(floor[sl].ravel(), vol[vsl].ravel())[0, 1]
    assert cc > 0.7 > np.corrcoef(raw[sl].ravel(), vol[vsl].ravel())[0, 1]


def test_adjacent_tracking_keeps_the_axis_rotation(monkeypatch):
    """A flat textured layer turned by 3° about the beam: the JAX tracker
    (every tilt against the zero tilt) sees only part of the rotation's
    y motion; following each patch from tilt to tilt recovers it."""
    from scipy.ndimage import gaussian_filter, map_coordinates

    rng = np.random.RandomState(7)
    n, T = 160, 25
    angles = np.linspace(-60.0, 60.0, T)
    alpha = np.radians(3.0)
    layer = gaussian_filter(rng.randn(2 * n, 2 * n), 2.0)
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float64) - n // 2
    tilts = []
    for th in np.radians(angles):
        # image point -> layer point: undo the axis turn, then the
        # foreshortening along x'
        xp = np.cos(alpha) * xx + np.sin(alpha) * yy
        yl = np.cos(alpha) * yy - np.sin(alpha) * xx
        tilts.append(map_coordinates(layer, [yl + n, xp / np.cos(th) + n],
                                     order=1))
    tilts = np.asarray(tilts, np.float32)
    g = np.linspace(n * 0.25, n * 0.75, 3)
    centers = np.array([(y, x) for y in g for x in g], np.float32)
    sh = np.zeros((T, 2), np.float32)
    found = {}
    for adjacent in (False, True):
        monkeypatch.setattr(ttomo, "TILT_TO_TILT", adjacent)
        tracks = ttomo.track_patches(tilts, sh, angles, centers, 32,
                                     device=CPU)
        model, _ = ttomo.solve_projection_model_robust(tracks, angles, (n, n))
        found[adjacent] = float(model.axis_angle)
    assert abs(found[True] - 3.0) <= 0.3, found
    assert abs(found[True] - 3.0) < abs(found[False] - 3.0), found
