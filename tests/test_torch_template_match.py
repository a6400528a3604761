"""Parity of the port's 3D template matching, virion detection and surface
refinement (pyp_tpu_torch/ops/template_match.py), filament and membrane
segmentation (ops/filament.py) and classical denoisers
(ops/denoise_classic.py) with the JAX package's, on the CPU, on small
seeded volumes (32-48 voxels a side): a tomogram of dark Gaussian blobs,
a shell, a rod and a sheet.

Tolerances: volumes, score maps and filter outputs rtol 1e-4 with atol
1e-4 * max|reference| (separable box sums and reductions run in another
order than XLA's); even and odd box windows (`norm_size`, `patch_size`)
both checked, since XLA's "SAME" pads an even window (k-1)//2 before and
k//2 after; peaks as sets of the valid (z, y, x); best-rotation indices
equal wherever the two best scores differ by more than 1e-4; surface
points, radii and eulers within 1e-3 (voxels, degrees); the
refine_surface_sh gradient at c = 0 (one normalized step, through
jax.value_and_grad and torch.autograd) within 1e-3 voxels; filament picks
on the planted tilt series within 1e-3 voxels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyp_tpu.ops import denoise_classic as jdn
from pyp_tpu.ops import filament as jfil
from pyp_tpu.ops import template_match as jtm
from pyp_tpu_torch.ops import denoise_classic as tdn
from pyp_tpu_torch.ops import filament as tfil
from pyp_tpu_torch.ops import template_match as ttm

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


def blob_tomogram(shape=(24, 40, 40), n=5, seed=0, sigma=2.0):
    rng = np.random.RandomState(seed)
    zz, yy, xx = np.mgrid[0:shape[0], 0:shape[1], 0:shape[2]]
    vol = 0.3 * rng.randn(*shape)
    centres = []
    for _ in range(n):
        c = [rng.randint(min(6, s // 3), s - min(6, s // 3)) for s in shape]
        centres.append(c)
        vol -= np.exp(-((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2)
                      / (2 * sigma ** 2))
    return vol.astype(np.float32), np.asarray(centres)


def shell_tomogram(n=40, centre=(20, 19, 21), radius=9.0, seed=1):
    rng = np.random.RandomState(seed)
    zz, yy, xx = np.mgrid[0:n, 0:n, 0:n]
    r = np.sqrt((zz - centre[0]) ** 2 + (yy - centre[1]) ** 2
                + (xx - centre[2]) ** 2)
    vol = -np.exp(-0.5 * ((r - radius) / 1.5) ** 2) + 0.1 * rng.randn(n, n, n)
    return vol.astype(np.float32)


# ---------------------------------------------------------------------------
# template matching
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 4, 5, 8])
def test_box_mean(k):
    vol, _ = blob_tomogram((12, 14, 16))
    close(ttm._box_mean(torch.from_numpy(vol), k), jtm._box_mean(jnp.asarray(vol), k))


@pytest.mark.parametrize("norm_size", [None, 7, 8])
def test_match_template_3d(norm_size):
    vol, _ = blob_tomogram()
    zz, yy, xx = np.mgrid[-4:4, -4:4, -4:4]
    tpl = -np.exp(-(zz ** 2 + 2 * yy ** 2 + xx ** 2) / 8.0).astype(np.float32)
    angles = np.array([[0, 0, 0], [30, 40, 50], [90, 90, 0]], np.float32)
    ps, pi = ttm.match_template_3d(vol, tpl, angles, norm_size=norm_size,
                                   device=CPU)
    js, ji = jtm.match_template_3d(vol, tpl, angles, norm_size=norm_size)
    close(ps, js)
    js = np.asarray(js)
    # where the two best rotations score apart, the same rotation wins
    scores = np.stack([np.asarray(jtm.match_template_3d(
        vol, tpl, angles[a:a + 1], norm_size=norm_size)[0]) for a in range(3)])
    top2 = np.sort(scores, axis=0)[-2:]
    clear = (top2[1] - top2[0]) > 1e-4
    np.testing.assert_array_equal(pi.numpy()[clear], np.asarray(ji)[clear])


@pytest.mark.parametrize("md,n_peaks,thr", [(3, 8, 0.0), (2, 40, 0.5),
                                            (4, 200, 0.0)])
def test_pick_peaks_3d(md, n_peaks, thr):
    vol, _ = blob_tomogram()
    score = -vol
    pc, pv, pok = ttm.pick_peaks_3d(torch.from_numpy(score), n_peaks, md, thr)
    jc, jv, jok = jtm.pick_peaks_3d(jnp.asarray(score), n_peaks, md, thr)
    pok, jok = pok.numpy(), np.asarray(jok)
    assert pok.sum() == jok.sum()
    assert ({tuple(c) for c in pc.numpy()[pok]}
            == {tuple(c) for c in np.asarray(jc)[jok]})
    np.testing.assert_allclose(np.sort(pv.numpy()[pok]),
                               np.sort(np.asarray(jv)[jok]), rtol=1e-6)


@pytest.mark.parametrize("radius,thick", [(5.0, 2.0), (7.5, 1.5)])
def test_spherical_shell_template(radius, thick):
    close(ttm.spherical_shell_template(radius, thick),
          jtm.spherical_shell_template(radius, thick), rtol=0, atol_rel=0)


@pytest.mark.parametrize("fn", ["detect_spheres", "detect_spheres_template"])
def test_detect_spheres(fn):
    vol = shell_tomogram()
    if fn == "detect_spheres_template":
        vol = -vol
    radii = [7.0, 9.0, 11.0, 40.0]          # 40 does not fit: dropped
    pc, pr, ps, pok = getattr(ttm, fn)(vol, radii, n_peaks=4, device=CPU)
    jc, jr, js, jok = getattr(jtm, fn)(vol, radii, n_peaks=4)
    pok, jok = pok.numpy(), np.asarray(jok)
    np.testing.assert_array_equal(pok, jok)
    np.testing.assert_array_equal(pc.numpy()[pok], np.asarray(jc)[jok])
    np.testing.assert_array_equal(pr.numpy()[pok], np.asarray(jr)[jok])
    np.testing.assert_allclose(ps.numpy()[pok], np.asarray(js)[jok], rtol=1e-4)
    assert np.abs(pc.numpy()[0] - [20, 19, 21]).max() <= 1
    assert pr.numpy()[0] == 9.0


def test_detect_spheres_with_no_radius_that_fits():
    pc, pr, ps, pok = ttm.detect_spheres(np.zeros((16, 16, 16), np.float32),
                                         [20.0], n_peaks=3, device=CPU)
    assert pc.shape == (3, 3) and not pok.any()


def test_sphere_surface_points():
    for p, j in zip(ttm.sphere_surface_points(np.array([3.0, 4.0, 5.0]), 7.0, 50),
                    jtm.sphere_surface_points(np.array([3.0, 4.0, 5.0]), 7.0, 50)):
        np.testing.assert_array_equal(p, j)


def test_match_on_surface():
    vol = shell_tomogram()
    pts, nrm = jtm.sphere_surface_points(np.array([20.0, 19.0, 21.0]), 9.0, 24)
    tpl = ttm.spherical_shell_template(2.0, 1.0).numpy()[:6, :6, :6]
    ps, pp = ttm.match_on_surface(vol, tpl, pts, nrm, psi_step=90.0,
                                  device=CPU)
    js, jp = jtm.match_on_surface(vol, tpl, pts, nrm, psi_step=90.0)
    close(ps, js, rtol=1e-4, atol_rel=1e-4)
    clear = np.abs(ps.numpy()) > 1e-3
    np.testing.assert_array_equal(pp.numpy()[clear], np.asarray(jp)[clear])


@pytest.mark.parametrize("dark,smooth", [(True, 2), (False, 0)])
def test_refine_virion_surface(dark, smooth):
    vol = shell_tomogram()
    kw = dict(n_points=60, dark_membrane=dark, smooth_iters=smooth)
    port = ttm.refine_virion_surface(vol, [20.0, 19.0, 21.0], 8.0,
                                     device=CPU, **kw)
    ref = jtm.refine_virion_surface(vol, [20.0, 19.0, 21.0], 8.0, **kw)
    for p, j in zip(port, ref):
        np.testing.assert_allclose(p, np.asarray(j), atol=1e-3)
    if dark:
        assert abs(np.median(port[2]) - 9.0) < 1.0


@pytest.mark.parametrize("l_max", [2, 4])
def test_sh_basis(l_max):
    _, nrm = jtm.sphere_surface_points(np.zeros(3), 1.0, 30)
    for p, j in zip(ttm._sh_basis(nrm, l_max), jtm._sh_basis(nrm, l_max)):
        np.testing.assert_array_equal(p, j)


@pytest.mark.parametrize("iters,centre", [(1, (20.0, 19.0, 21.0)),
                                          (1, (20.4, 18.6, 21.3)),
                                          (30, (20.4, 18.6, 21.3))],
                         ids=["grad_at_0", "grad_at_0_offcentre", "descent"])
def test_refine_surface_sh(iters, centre):
    """iters=1: the first step is -lr * g/|g| at c = 0, so equal radii
    mean the torch.autograd gradient at c = 0 points as
    jax.value_and_grad's does."""
    vol = shell_tomogram()
    kw = dict(n_points=80, l_max=4, iters=iters, search=0.3)
    port = ttm.refine_surface_sh(vol, centre, 8.5, device=CPU, **kw)
    ref = jtm.refine_surface_sh(vol, centre, 8.5, **kw)
    for p, j in zip(port, ref):
        np.testing.assert_allclose(p, np.asarray(j), atol=1e-3)


# ---------------------------------------------------------------------------
# filaments and membranes
# ---------------------------------------------------------------------------

def rod_and_sheet(n=32, seed=2):
    rng = np.random.RandomState(seed)
    zz, yy, xx = np.mgrid[0:n, 0:n, 0:n].astype(np.float32)
    rod = np.exp(-((zz - 10) ** 2 + (yy - 14) ** 2) / (2 * 1.5 ** 2))
    sheet = np.exp(-((zz - 22) ** 2) / (2 * 1.2 ** 2))
    vol = -(rod + sheet) + 0.05 * rng.randn(n, n, n)
    return vol.astype(np.float32)


@pytest.mark.parametrize("sigma", [1.0, 2.5])
def test_hessian_spectral(sigma):
    vol = rod_and_sheet(24)
    close(tfil._hessian_spectral(torch.from_numpy(vol), sigma),
          jfil._hessian_spectral(jnp.asarray(vol), sigma))


def test_eig3_and_axis_vector():
    rng = np.random.RandomState(3)
    H = rng.randn(200, 6).astype(np.float32)
    pl = tfil._eig3_symmetric(torch.from_numpy(H))
    jl = jfil._eig3_symmetric(jnp.asarray(H))
    close(pl, jl, atol_rel=1e-5)
    for k in (0, 2):
        pa = tfil._axis_vector(torch.from_numpy(H), pl[..., k]).numpy()
        ja = np.asarray(jfil._axis_vector(jnp.asarray(H), jl[..., k]))
        # an eigenvector's sign is arbitrary only where the cross products
        # tie; the same row wins here
        np.testing.assert_allclose(pa, ja, atol=2e-3)


@pytest.mark.parametrize("fn,dark", [("vesselness", True), ("vesselness", False),
                                     ("sheetness", True)])
def test_vesselness_and_sheetness(fn, dark):
    vol = rod_and_sheet()
    pv, pa = getattr(tfil, fn)(vol, 1.5, dark=dark, device=CPU)
    jv, ja = getattr(jfil, fn)(jnp.asarray(vol), 1.5, dark=dark)
    close(pv, jv, atol_rel=1e-4)
    strong = pv.numpy() > 0.1 * float(pv.max())
    dots = np.abs((pa.numpy() * np.asarray(ja)).sum(-1))[strong]
    assert np.all(dots > 0.999)


def test_segment_membranes():
    vol = rod_and_sheet()
    pm, ps, pn = tfil.segment_membranes(vol, thickness_px=3.0, device=CPU)
    jm, js, jn = jfil.segment_membranes(vol, thickness_px=3.0)
    close(ps, js)
    assert (pm != np.asarray(jm)).mean() < 1e-3
    assert pm[22].mean() > 0.5 and pm[5].mean() < 0.05


def test_trace_filaments_is_the_same():
    rng = np.random.RandomState(4)
    pts = np.stack([np.full(30, 10.0), np.full(30, 14.0), np.arange(30.0)], 1)
    pts = np.concatenate([pts, rng.uniform(0, 30, (10, 3))]).astype(np.float32)
    axes = np.tile([0.0, 0.0, 1.0], (40, 1)).astype(np.float32)
    scores = rng.rand(40).astype(np.float32)
    p = tfil.trace_filaments(pts, axes, scores)
    j = jfil.trace_filaments(pts, axes, scores)
    assert len(p) == len(j) and all(np.array_equal(a, b) for a, b in zip(p, j))


@pytest.mark.parametrize("radius", [2.0, (1.5, 3.0)])
def test_pick_filaments(radius):
    vol = rod_and_sheet()
    vol[20:] = 0.05 * np.random.RandomState(5).randn(12, 32, 32)
    pc, pe, pi = tfil.pick_filaments(vol, radius, 4.0, device=CPU)
    jc, je, ji = jfil.pick_filaments(vol, radius, 4.0)
    assert len(pc) == len(jc) > 3
    np.testing.assert_allclose(pc, jc, atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(pe, je, atol=1e-3)
    np.testing.assert_array_equal(pi, ji)
    assert np.median(np.hypot(pc[:, 0] - 10, pc[:, 1] - 14)) <= 2.0


# ---------------------------------------------------------------------------
# classical denoisers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3, 4])
def test_box_filter_3d(k):
    vol, _ = blob_tomogram((10, 12, 14))
    close(tdn._box_filter_3d(torch.from_numpy(vol), k),
          jdn._box_filter_3d(jnp.asarray(vol), k))


@pytest.mark.parametrize("patch_size,nsearch,step", [(4, 5, 2), (3, 3, 1)])
def test_nlm_denoise_3d(patch_size, nsearch, step):
    vol, _ = blob_tomogram((12, 16, 16))
    kw = dict(patch_size=patch_size, nsearch=nsearch, sigma=0.3, step=step)
    close(tdn.nlm_denoise_3d(vol, device=CPU, **kw),
          jdn.nlm_denoise_3d(jnp.asarray(vol), **kw))


def test_nad_denoise_3d():
    vol, _ = blob_tomogram((12, 16, 16))
    close(tdn.nad_denoise_3d(vol, iters=5, sigma=0.4, device=CPU),
          jdn.nad_denoise_3d(jnp.asarray(vol), iters=5, sigma=0.4))


@pytest.mark.parametrize("method,iters", [("bm4d", 1), ("bm4d", 2),
                                          ("nad", 1), ("imod-nad", 2)])
def test_denoise_map(method, iters):
    vol, _ = blob_tomogram((10, 12, 12))
    kw = dict(method=method, nsearch=5, iters=iters)
    close(tdn.denoise_map(vol, device=CPU, **kw), jdn.denoise_map(vol, **kw))


def test_pick_filaments_on_the_planted_series():
    """Both packages' pickers on one WBP tomogram of `tools/e2e_tomo`'s
    series at half the smoke run's resolution (41 tilts of 512² at 8 Å/px,
    no shifts, no axis turn, a 256² x 128 tomogram at 16 Å/px, the default
    particle radius of 100 Å): the same picks, and they miss the planted
    rod (median distance over 2 voxels) for the membrane sheet, the
    virions and the crowd. This is the reference's defect that keeps
    chip_smoke.py's filament reading off its 2-voxel mark (ROADMAP
    Queue 3)."""
    from pyp_tpu_torch.core.fft import bin_images
    from pyp_tpu_torch.ops import tomo as ttomo
    from pyp_tpu_torch.tools import e2e_tomo

    classes, truth, image = e2e_tomo.make_truth(**dict(
        e2e_tomo.SERIES, size=512, pixel=8.0, shift_px=0.0, axis_angle=0.0))
    ang = np.asarray(truth["angles"], np.float32)
    gen = torch.Generator().manual_seed(0)
    rates = torch.stack(list(e2e_tomo.expected_rates(
        classes, ang, np.zeros((len(ang), 2)), truth["defoci"], 512, 8.0,
        0.0, truth["hand"], image["contrast"], image["ice"], image["dose"],
        gen, CPU)))
    tilts = bin_images(torch.poisson(rates, generator=gen), 2)
    rec = ttomo.wbp_reconstruct(tilts, ang, thickness=128, device=CPU)
    pc, pe, pi = tfil.pick_filaments(rec, 6.0, 12.0, device=CPU)
    jc, je, ji = jfil.pick_filaments(rec.numpy(), 6.0, 12.0)
    assert len(pc) == len(jc) > 0
    np.testing.assert_allclose(pc, jc, atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(pe, je, atol=1e-3)
    p0, p1 = e2e_tomo.rec_voxel([truth["filament"]["p0"],
                                 truth["filament"]["p1"]], rec.shape, 16.0)
    assert np.median(e2e_tomo.distance_to_segment(pc[:, :3], p0, p1)) > 2.0


def test_planted_rod_keeps_its_counts_above_zero():
    """The zero tilt of `tools/e2e_tomo`'s series at 4 Å/px (1024²): the
    rod's expected counts stay above zero along its axis, so its profile
    in the tomogram is the planted one. At 8 x its weight (the fixture's
    earlier rod) `clamp(1 + image, 0)` zeroes the counts across more than
    100 Å of the rod (28 px), and the tomogram shows a hollow tube."""
    from pyp_tpu_torch.tools import e2e_tomo

    classes, truth, image = e2e_tomo.make_truth(**dict(
        e2e_tomo.SERIES, size=1024, pixel=4.0))
    f = truth["filament"]
    ys = slice(int(f["p0"][1] / 4 + 512) + 5, int(f["p1"][1] / 4 + 512) - 5)
    xc = int(round(f["p0"][2] / 4 + 512))
    widths = {}
    for scale in (1.0, 8.0):
        cl = {k: dict(c) for k, c in classes.items()}
        cl["filament"]["weight"] = classes["filament"]["weight"] * scale
        gen = torch.Generator().manual_seed(0)
        rate = next(e2e_tomo.expected_rates(
            cl, np.zeros(1, np.float32), np.zeros((1, 2)), truth["defoci"][:1],
            1024, 4.0, 0.0, truth["hand"], image["contrast"], 0.0,
            image["dose"], gen, CPU))
        profile = rate[ys, xc - 40:xc + 41].mean(0).numpy()
        widths[scale] = 4.0 * int((profile == 0.0).sum())
        if scale == 1.0:
            assert profile.min() > 0.3 * image["dose"]
    assert widths[8.0] > 100.0, widths
