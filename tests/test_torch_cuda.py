"""The port's CUDA path against its own CPU path, module by module: every
layer of the refinement slice (global search through the CUDA kernel,
the autograd polish, insertion with atomics, the FRM engine with either
polar sampler, the reference auto-mask, per-particle defocus, the refine
loop with either engine) gives on a card what the CPU path, held to the
JAX package by the other test_torch_* files, gives on the same seeded
inputs.

All tests here need a card and no JAX; on a CUDA machine they run with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels.py tests/test_torch_cuda.py

Tolerances (box 32, 2 Å/px, 24 particles): global_search candidates the
same on >= 95% of (particle, k) slots, top scores within 1e-4; local
polish >= 95% of particles within 0.05° and 0.01 px; maps atol 1e-4 *
max|map| and FSC atol 1e-3 (insertion sums in another order on the card);
one refine_loop iteration >= 90% of poses within 1° and map cc >= 0.99;
frm_refine >= 90% of poses equal to 1e-3 (° and px) and their scores
within 1e-4 (the match rounds its inputs to bfloat16, so a last-bit
difference between the devices' FFTs can move a near-tie); auto_mask
within 1e-5 with the same binary core; refine_defocus within 0.5 Å,
scores within 1e-5; one FRM iteration with half banks and the polish
>= 90% of poses within 1° and map cc >= 0.99.

The SPA back half (phases of the masked FSC drawn once on the CPU and
shared, since each device's generator draws its own): reconstruction
with IEWALD ±2 and likelihood blurring maps atol 1e-4 * max|map|, FSC
atol 1e-3; the mask-corrected FSC atol 1e-4; postprocess_latest with
local resolution: resolution within 1e-3 Å, maps atol 1e-3 * max|map|;
model_map_fit cc within 1e-4 and the same shift; the loop with every
reconstruction option >= 90% of poses within 1°, map cc >= 0.99, the
same files; the fsc and mask modes' files atol 1e-4 / 1e-5.

The classification slice: the gather E-step through the kernel (one
launch) and the polar E-step >= 95% / 90% of particles with the same
class, psi and shift, scores within 1e-4; the M-step at the same
alignment atol 1e-4 * max; one classify3d_iteration >= 90% of
assignments equal, class maps cc >= 0.99.

The preprocessing slice (a 12 x 128² movie with a planted drift, a 512²
micrograph): alignment shifts within 1e-2 px and averages atol 1e-4 *
max|average| (small and camera-sized path); periodogram rtol 1e-4; fit_ctf
defocus within 0.2 * dfstep, angle within 2°; medians exact; picks the
same set of coordinates; extracted stacks atol 1e-4 * max; one
process_micrograph + extract_stack: the same picks, drift within 1e-2 px,
stacks atol 1e-3 * max. The session daemon on one 256² movie: the same
particle count and picks, drift within 1e-2 px (its summed path length
within 0.1 px), defocus within 50 Å.

The tomography slice (13 tilts of 256² from tools/e2e_tomo): prealign
and patch and bead tracks within 1e-2 px; volumes, aligned and
CTF-corrected tilts atol 1e-4 * max (SART 1e-3); template scores and
filters atol 1e-4 * max, peaks the same set, surface radii within 1e-3
voxel; one process_tilt_series: alignment within 1e-2 px, defocus within
50 Å, tomogram atol 1e-3 * max, the same picks.

The subtomogram slice (a 7-tilt series of 6 particles, box 24, made with
the port's own CPU projection): a vectorized csp_refine_batch of two
series with a grid search on the card against the sequential one on the
CPU, parameters within 1e-3 (° and px), scores within 1e-4; csp_classify
against two maps, occupancies within 1e-3 and class maps within 3e-3 *
max below 0.85 Nyquist; accumulate_matrices of band-limited windows,
half maps atol 1e-4 * max; the SVA score block the same angles and
shifts, scores within 1e-4; refine_trajectories within 1e-3 px.

The models (convolutions at cuDNN's default precision, TF32 on Hopper):
the U-Net and the 3D encoder within 1e-2 x max, one Adam step of the
picker on 95% of its kernel elements within 0.1 lr, batched tiled
inference within 1e-2, the heterogeneity loss within 1e-3 relative and
its gradients within 1e-2 x max.
"""

import numpy as np
import pytest
import torch

from pyp_tpu.config import schema
from pyp_tpu.io import cistem
from pyp_tpu_torch.ops import fourier_slice as fs
from pyp_tpu_torch.ops import frm, kernels
from pyp_tpu_torch.ops import reconstruct as rec
from pyp_tpu_torch.ops import refine3d as r3
from pyp_tpu_torch.pipeline import refine as ref_pipe
from pyp_tpu_torch.tools import e2e_spa

N, PIXEL = 32, 2.0

# the string condition is evaluated when each test runs, not at import
pytestmark = [pytest.mark.cuda,
              pytest.mark.skipif("not torch.cuda.is_available()",
                                 reason="needs a CUDA card")]


def bandlimit(imgs, kmax=7):
    """Zero every Fourier component at |k| >= kmax: keeps the ky = -n/2
    row, whose in-sphere test is a last-bit question of each device's own
    rotation matrix, free of signal."""
    n = imgs.shape[-1]
    ky = np.fft.fftfreq(n)[:, None] * n
    kx = np.fft.rfftfreq(n)[None, :] * n
    keep = np.sqrt(ky ** 2 + kx ** 2) < kmax
    return np.fft.irfft2(np.fft.rfft2(imgs) * keep, s=(n, n)).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    return e2e_spa.make_dataset(n_particles=24, box=N, pixel=PIXEL,
                                noise_x=0.3, content_a=3.0 * PIXEL,
                                shift_max=2.0, seed=1)


def on(x, dev):
    return torch.as_tensor(np.asarray(x)).to(dev)


def truth_poses(data):
    return np.stack([data["phi"], data["theta"], data["psi"],
                     -data["shifts"][:, 0], -data["shifts"][:, 1]],
                    1).astype(np.float32)


def test_global_search(data):
    dirs = r3.make_directions(15.0)
    psis = np.arange(0.0, 360.0, 10.0, dtype=np.float32)
    pts = r3.make_mask_points(N, PIXEL, 100.0, 3.0 * PIXEL)
    grid = r3.make_shift_grid(3.0, 1.5)

    def run(dev):
        return r3.global_search(
            on(data["stack"], dev), on(data["ctf_params"], dev),
            fs.volume_to_fourier(on(data["volume"], dev)), on(dirs, dev),
            on(psis, dev), on(pts, dev), on(grid, dev), N, PIXEL)

    launches = kernels.shift_scored_match.launches
    pose, score = run("cuda")
    assert kernels.shift_scored_match.launches == launches + 1
    ref_pose, ref_score = run("cpu")
    pose, ref_pose = pose.cpu().numpy(), ref_pose.numpy()
    B, K = ref_pose.shape[:2]
    hits = [np.any(np.all(np.abs(ref_pose[b] - pose[b, k]) < 1e-3, axis=1))
            for b in range(B) for k in range(K)]
    assert np.mean(hits) >= 0.95, np.mean(hits)
    np.testing.assert_allclose(np.sort(score.cpu().numpy(), 1),
                               np.sort(ref_score.numpy(), 1), atol=1e-4)


def test_local_refine(data):
    rng = np.random.RandomState(3)
    init = truth_poses(data) + np.concatenate(
        [rng.uniform(-8, 8, (24, 3)), rng.uniform(-1, 1, (24, 2))],
        1).astype(np.float32)
    pts = r3.make_mask_points(N, PIXEL, 100.0, 2.5 * PIXEL)

    def run(dev):
        return r3.local_refine(
            on(data["stack"], dev), on(data["ctf_params"], dev),
            fs.volume_to_fourier(on(data["volume"], dev)), on(init, dev),
            on(pts, dev), N, PIXEL)

    p, s = (x.cpu().numpy() for x in run("cuda"))
    ref_p, ref_s = (x.numpy() for x in run("cpu"))
    ang = np.abs(((p[:, :3] - ref_p[:, :3]) + 180.0) % 360.0 - 180.0).max(1)
    sh = np.abs(p[:, 3:] - ref_p[:, 3:]).max(1)
    assert np.mean((ang < 0.05) & (sh < 0.01)) >= 0.95, (ang, sh)
    np.testing.assert_allclose(s, ref_s, atol=1e-4)


@pytest.mark.parametrize("crop_to", [None, 16])
def test_reconstruct(data, crop_to):
    stack = bandlimit(data["stack"])

    def run(dev):
        return rec.reconstruct(stack, truth_poses(data), data["ctf_params"],
                               PIXEL, batch=10, crop_to=crop_to, device=dev)

    out, ref = run("cuda"), run("cpu")
    for name in ("volume", "half1", "half2"):
        a = getattr(out, name).cpu().numpy()
        b = getattr(ref, name).numpy()
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-4 * float(np.abs(b).max()),
                                   err_msg=name)
    np.testing.assert_allclose(out.fsc.cpu().numpy(), ref.fsc.numpy(),
                               atol=1e-3)


def test_refine_loop(data, tmp_path):
    init = e2e_spa.starting_map(data["volume"], PIXEL, 12.0)
    params = schema.defaults()
    params.update({
        "scope_pixel": PIXEL, "refine_engine": "gather", "refine_maxiter": 1,
        "refine_rhref": "8", "refine_dang": "15", "refine_psi_step": 10.0,
        "refine_searchx": 3.0, "refine_shift_step": 1.5,
        "refine_rlref": 100.0, "plot_per_item": False,
    })
    outs = {}
    for dev in ("cuda", "cpu"):
        work = tmp_path / dev
        work.mkdir()
        e2e_spa.write_project(work, data, init, pixel=PIXEL)
        table = cistem.read_parameters(work / "stack.cistem")
        outs[dev] = ref_pipe.refine_loop(data["stack"], table, init,
                                         dict(params), work_dir=work,
                                         dataset="ds", device=dev)
    (tc, mc, _), (th, mh, _) = outs["cuda"], outs["cpu"]
    rc = e2e_spa.angular_error_deg(tc["phi"], tc["theta"], tc["psi"], {
        "phi": th["phi"], "theta": th["theta"], "psi": th["psi"]})
    assert np.mean(rc < 1.0) >= 0.9, rc
    cc = np.corrcoef(mc.cpu().numpy().ravel(), mh.numpy().ravel())[0, 1]
    assert cc >= 0.99, cc


FRM_CFG = dict(low_res=30.0, high_res=6.0, angular_step=11.0,
               shift_extent=3.0, shift_step=0.5)


@pytest.mark.parametrize("mode,local", [("matmul", False), ("gather", False),
                                        ("matmul", True)])
def test_frm_refine(data, monkeypatch, mode, local):
    monkeypatch.setenv("PYP_TPU_FRM_POLAR", mode)
    init = truth_poses(data) + 2.0 if local else None

    def run(dev):
        cfg = frm.FrmConfig(N, PIXEL, device=dev, **FRM_CFG)
        assert cfg.polar_gather == (mode == "gather")
        return frm.frm_refine(
            data["stack"], data["ctf_params"],
            fs.volume_to_fourier(on(data["volume"], dev)), cfg,
            init_poses=init, prior_cone_deg=10.0 if local else None)

    p, s = (x.cpu().numpy() for x in run("cuda"))
    ref_p, ref_s = (x.numpy() for x in run("cpu"))
    same = np.all(np.abs(p - ref_p) < 1e-3, axis=1)
    assert same.mean() >= 0.9, p - ref_p
    np.testing.assert_allclose(s[same], ref_s[same], atol=1e-4)


def test_auto_mask(data):
    from pyp_tpu_torch.postprocess.core import auto_mask

    m = auto_mask(on(data["volume"], "cuda"), pixel_size=PIXEL).cpu().numpy()
    ref = auto_mask(on(data["volume"], "cpu"), pixel_size=PIXEL).numpy()
    np.testing.assert_allclose(m, ref, atol=1e-5)
    np.testing.assert_array_equal(m > 0.99, ref > 0.99)


def test_refine_defocus(data):
    wrong = data["ctf_params"].copy()
    wrong[:, :2] += np.random.RandomState(7).uniform(-300, 300, (24, 1))
    pts = r3.make_mask_points(N, PIXEL, 100.0, 2.2 * PIXEL)

    def run(dev):
        return r3.refine_defocus(
            on(data["stack"], dev), on(wrong, dev),
            fs.volume_to_fourier(on(data["volume"], dev)),
            on(truth_poses(data), dev), on(pts, dev), N, PIXEL)

    cp, s = (x.cpu().numpy() for x in run("cuda"))
    ref_cp, ref_s = (x.numpy() for x in run("cpu"))
    np.testing.assert_allclose(cp, ref_cp, atol=0.5)
    np.testing.assert_allclose(s, ref_s, atol=1e-5)


def test_frm_iteration_with_half_banks(data, tmp_path):
    """One final FRM iteration in local mode with gold-standard half maps:
    each half's rows matched against its own bank, then polished."""
    init = e2e_spa.starting_map(data["volume"], PIXEL, 12.0)
    halves = (init, e2e_spa.starting_map(data["volume"], PIXEL, 10.0))
    params = schema.defaults()
    params.update({
        "scope_pixel": PIXEL, "refine_engine": "frm", "refine_maxiter": 1,
        "refine_rhref": "8", "refine_dang": "12", "refine_searchx": 3.0,
        "refine_rlref": 100.0, "refine_goldstandard": True,
        "refine_frm_cone": 15.0, "plot_per_item": False,
    })
    e2e_spa.write_project(tmp_path, data, init, pixel=PIXEL)
    table = cistem.read_parameters(tmp_path / "stack.cistem")
    tp = truth_poses(data)
    for i, k in enumerate(("phi", "theta", "psi")):
        table[k] = tp[:, i] + 3.0
    table["y_shift"] = tp[:, 3] * PIXEL
    table["x_shift"] = tp[:, 4] * PIXEL
    outs = {dev: ref_pipe.refinement_iteration(
        data["stack"], table.copy(), init, dict(params), 2,
        ref_halves=halves, device=dev) for dev in ("cuda", "cpu")}
    (tc, rc, _), (th, rh, _) = outs["cuda"], outs["cpu"]
    err = e2e_spa.angular_error_deg(tc["phi"], tc["theta"], tc["psi"], {
        "phi": th["phi"], "theta": th["theta"], "psi": th["psi"]})
    assert np.mean(err < 1.0) >= 0.9, err
    cc = np.corrcoef(rc.volume.cpu().numpy().ravel(),
                     rh.volume.numpy().ravel())[0, 1]
    assert cc >= 0.99, cc


# --- the SPA back half -----------------------------------------------------

def _cpu_phases(shape, seed, device):
    """Phases drawn on the CPU for a seed, moved to `device`: the same on
    both devices."""
    gen = torch.Generator().manual_seed(int(seed))
    return (torch.rand(tuple(shape), generator=gen) * (2 * np.pi)).to(device)


@pytest.fixture
def shared_phases(monkeypatch):
    from pyp_tpu_torch.postprocess import core as post

    monkeypatch.setattr(post, "_random_phases", _cpu_phases)


@pytest.fixture(scope="module")
def halves(data):
    rng = np.random.RandomState(4)
    v = data["volume"]
    amp = 0.4 * v.std()
    return (v + amp * rng.randn(*v.shape).astype(np.float32),
            v + amp * rng.randn(*v.shape).astype(np.float32))


@pytest.mark.parametrize("kw", [dict(iewald=2, ref=True, crop_to=16),
                                dict(iewald=-1),
                                dict(lblur_nrot=21, lblur_range=20.0)],
                         ids=["iewald2_crop", "iewald-1", "lblur21"])
def test_reconstruct_options(data, kw):
    stack = bandlimit(data["stack"])
    kw = dict(kw)
    if kw.pop("ref", False):
        kw["ref_volume"] = data["volume"]

    def run(dev):
        return rec.reconstruct(stack, truth_poses(data), data["ctf_params"],
                               PIXEL, batch=10, device=dev, **kw)

    out, ref = run("cuda"), run("cpu")
    for name in ("volume", "half1", "half2"):
        b = getattr(ref, name).numpy()
        np.testing.assert_allclose(getattr(out, name).cpu().numpy(), b, rtol=0,
                                   atol=1e-4 * float(np.abs(b).max()),
                                   err_msg=name)
    np.testing.assert_allclose(out.fsc.cpu().numpy(), ref.fsc.numpy(), atol=1e-3)


def test_masked_fsc_and_local_resolution(halves, shared_phases):
    from pyp_tpu_torch.postprocess import core as post
    from pyp_tpu_torch.postprocess import locres

    h1, h2 = halves
    mask = post.auto_mask(on(h1 + h2, "cpu"), pixel_size=PIXEL)
    out = {}
    for dev in ("cuda", "cpu"):
        _, curve = post.masked_fsc(on(h1, dev), on(h2, dev), mask.to(dev), PIXEL)
        lr, _, vals = locres.local_resolution(h1, h2, PIXEL, sampling_a=16.0,
                                              device=dev)
        out[dev] = (curve.cpu().numpy(), lr.cpu().numpy(), vals)
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], atol=1e-4)
    np.testing.assert_allclose(out["cuda"][2], out["cpu"][2], atol=1e-3)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], atol=1e-3 * float(
        np.abs(out["cpu"][1]).max()))


def test_postprocess_latest(halves, tmp_path, shared_phases):
    from pyp_tpu_torch.io import mrc
    from pyp_tpu_torch.postprocess import core as post

    params = {"plot_per_item": False, "sharpen_locres": True,
              "sharpen_locres_sampling": 16.0, "sharpen_ampl_corr": True,
              "sharpen_half_maps": True}
    outs = {}
    for dev in ("cuda", "cpu"):
        maps = tmp_path / dev / "maps"
        maps.mkdir(parents=True)
        mrc.write(halves[0], maps / "ds_r01_02_half1.mrc", pixel_size=PIXEL)
        mrc.write(halves[1], maps / "ds_r01_02_half2.mrc", pixel_size=PIXEL)
        outs[dev] = post.postprocess_latest("ds", dict(params), tmp_path / dev,
                                            device=dev)
    a, b = outs["cuda"], outs["cpu"]
    assert sorted(a) == sorted(b)
    assert a["resolution_A"] == pytest.approx(b["resolution_A"], abs=1e-3)
    for key in ("map", "locres_map", "locfilt_map", "half1_postprocessed"):
        x, y = mrc.read(a[key]), mrc.read(b[key])
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-3 * float(np.abs(y).max()),
                                   err_msg=key)


def test_model_map_fit(data, tmp_path):
    from pyp_tpu_torch.analysis.modelfit import model_map_fit
    from pyp_tpu_torch.io.pdb import read_pdb

    model = read_pdb(e2e_spa.write_pseudo_atom_pdb(
        data["volume"], PIXEL, N ** 3 // 32, tmp_path / "m.pdb"))
    fits = {dev: model_map_fit(model, data["volume"], PIXEL, low_res=50.0,
                               high_res=8.0, device=dev)
            for dev in ("cuda", "cpu")}
    assert fits["cuda"]["cc"] == pytest.approx(fits["cpu"]["cc"], abs=1e-4)
    np.testing.assert_array_equal(fits["cuda"]["shift_px"], fits["cpu"]["shift_px"])
    np.testing.assert_allclose(fits["cuda"]["fsc"], fits["cpu"]["fsc"], atol=1e-4)


def test_refine_loop_with_every_option(data, tmp_path):
    init = e2e_spa.starting_map(data["volume"], PIXEL, 12.0)
    pdb = e2e_spa.write_pseudo_atom_pdb(data["volume"], PIXEL, N ** 3 // 32,
                                        tmp_path / "m.pdb")
    params = schema.defaults()
    params.update({
        "scope_pixel": PIXEL, "refine_engine": "frm", "refine_maxiter": 2,
        "refine_rhref": "8:6", "refine_dang": "12", "refine_searchx": 3.0,
        "refine_rlref": 100.0, "refine_goldstandard": True,
        "refine_frm_cone": 15.0, "plot_per_item": False,
        "reconstruct_fbfact": True, "reconstruct_score_fraction": 0.9,
        "reconstruct_lblur": True, "reconstruct_iewald": 2,
        "refine_fmatch": True, "model_fit": pdb,
    })
    outs = {}
    for dev in ("cuda", "cpu"):
        work = tmp_path / dev
        work.mkdir()
        e2e_spa.write_project(work, data, init, pixel=PIXEL)
        table = cistem.read_parameters(work / "stack.cistem")
        outs[dev] = ref_pipe.refine_loop(data["stack"], table, init,
                                         dict(params), work_dir=work,
                                         dataset="ds", device=dev)
    (tc, mc, hc), (th, mh, hh) = outs["cuda"], outs["cpu"]
    err = e2e_spa.angular_error_deg(tc["phi"], tc["theta"], tc["psi"], {
        "phi": th["phi"], "theta": th["theta"], "psi": th["psi"]})
    assert np.mean(err < 1.0) >= 0.9, err
    assert np.corrcoef(mc.cpu().numpy().ravel(), mh.numpy().ravel())[0, 1] >= 0.99
    assert [set(h) for h in hc] == [set(h) for h in hh]
    names = sorted(p.name for p in (tmp_path / "cpu" / "maps").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "cuda" / "maps").iterdir())
    assert "ds_match.mrc" in names and "ds_r01_03_sharp.mrc" in names


def test_fsc_and_mask_modes(halves, tmp_path, monkeypatch, shared_phases):
    from pyp_tpu_torch import cli
    from pyp_tpu_torch.io import mrc

    for dev in ("cuda", "cpu"):
        work = tmp_path / dev
        work.mkdir()
        monkeypatch.chdir(work)
        mrc.write(halves[0], "h_half1.mrc", pixel_size=PIXEL)
        mrc.write(halves[1], "h_half2.mrc", pixel_size=PIXEL)
        assert cli.main(["mask", "-model_path", "h_half1.mrc", "-data_set",
                         "d"], device=dev) == 0
        assert cli.main(["fsc", "h_half1.mrc", "h_half2.mrc", "-fsc_mask",
                         "d_mask.mrc"], device=dev) == 0
    np.testing.assert_allclose(mrc.read(tmp_path / "cuda" / "d_mask.mrc"),
                               mrc.read(tmp_path / "cpu" / "d_mask.mrc"), atol=1e-5)
    np.testing.assert_allclose(np.loadtxt(tmp_path / "cuda" / "fsc.txt"),
                               np.loadtxt(tmp_path / "cpu" / "fsc.txt"), atol=1e-4)


# ---- the preprocessing slice ------------------------------------------------
def _movie(n_frames=12, n=128, drift=6.0, noise=0.5, seed=0):
    rng = np.random.RandomState(seed)
    fy = np.fft.fftfreq(n)[:, None]
    fx = np.fft.rfftfreq(n)[None, :]
    base = np.fft.irfft2(np.fft.rfft2(rng.randn(n, n))
                         * (np.sqrt(fy ** 2 + fx ** 2) < 0.25), s=(n, n)) * 10
    t = np.linspace(0, 1, n_frames)
    traj = np.stack([drift * (1 - np.exp(-3 * t)), -0.6 * drift * t ** 2], 1)
    traj -= traj.mean(axis=0, keepdims=True)
    ramp = np.exp(-2j * np.pi * (fy[None] * traj[:, 0, None, None]
                                 + fx[None] * traj[:, 1, None, None]))
    frames = np.fft.irfft2(np.fft.rfft2(base)[None] * ramp, s=(n, n))
    frames += noise * rng.randn(*frames.shape)
    return frames.astype(np.float32), traj.astype(np.float32)


def _blobs(n=512, n_particles=20, radius=16, seed=0):
    rng = np.random.RandomState(seed)
    img = rng.randn(n, n).astype(np.float32)
    ax = np.arange(-2 * radius, 2 * radius + 1)
    blob = np.exp(-(ax[:, None] ** 2 + ax[None, :] ** 2) / (radius * radius / 1.5))
    coords = rng.randint(3 * radius, n - 3 * radius, (n_particles, 2))
    for y, x in coords:
        img[y - 2 * radius:y + 2 * radius + 1,
            x - 2 * radius:x + 2 * radius + 1] -= 3.0 * blob
    return img, coords


def _near(cuda_t, cpu_t, atol_rel=1e-4, rtol=1e-4):
    a, b = cuda_t.cpu().numpy(), cpu_t.numpy()
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=atol_rel * float(np.abs(b).max()))


@pytest.mark.parametrize("kw", [dict(), dict(ref="middle", phase_only=True),
                                dict(tol=0.05, smooth_order=2)])
def test_align_movie_cuda_matches_cpu(kw):
    from pyp_tpu_torch.ops import motion

    frames, traj = _movie()
    kw = dict(bfactor=200.0, search_radius=20.0, **kw)
    c = motion.align_movie(frames, device="cpu", **kw)
    g = motion.align_movie(frames, device="cuda", **kw)
    assert g.shifts.is_cuda and g.average.is_cuda
    np.testing.assert_allclose(g.shifts.cpu().numpy(), c.shifts.numpy(), atol=1e-2)
    _near(g.average, c.average)
    assert np.abs(g.shifts.cpu().numpy() + traj).max() < 0.35


@pytest.mark.parametrize("binning,dose_weighted", [(1, True), (2, True),
                                                   (2, False)])
def test_align_movie_large_cuda_matches_cpu(binning, dose_weighted):
    from pyp_tpu_torch.ops import motion

    frames, _ = _movie()
    kw = dict(binning=binning, dose_weighted=dose_weighted, bfactor=200.0)
    c = motion.align_movie_large(frames, device="cpu", **kw)
    g = motion.align_movie_large(frames, device="cuda", **kw)
    np.testing.assert_allclose(g.shifts.cpu().numpy(), c.shifts.numpy(), atol=1e-2)
    _near(g.average, c.average)


def test_periodogram_and_fit_ctf_cuda_match_cpu():
    from pyp_tpu_torch.core.ctf import ctf_2d
    from pyp_tpu_torch.ops import ctf_fit

    rng = np.random.RandomState(1)
    c = ctf_2d((512, 512), 1.0, torch.tensor(19000.0), torch.tensor(17500.0),
               torch.tensor(40.0), 300.0, 2.7, 0.07).numpy()
    mic = np.fft.irfft2(np.fft.rfft2(rng.randn(512, 512)) * c, s=(512, 512))
    mic = (mic + 0.5 * rng.randn(512, 512)).astype(np.float32)
    pc = ctf_fit.periodogram(torch.from_numpy(mic), 256)
    pg = ctf_fit.periodogram(torch.from_numpy(mic).cuda(), 256)
    _near(pg, pc)
    kw = dict(dfmin=5000.0, dfmax=40000.0, dfstep=250.0, min_res=25.0,
              max_res=3.5)
    fc = ctf_fit.fit_ctf(pc, 1.0, device="cpu", **kw)
    fg = ctf_fit.fit_ctf(pc, 1.0, device="cuda", **kw)
    assert all(x.is_cuda for x in fg)
    fc, fg = [float(x) for x in fc], [float(x) for x in fg]
    assert abs(fg[0] - fc[0]) <= 50.0 and abs(fg[1] - fc[1]) <= 50.0, (fg, fc)
    assert abs((fg[2] - fc[2] + 90) % 180 - 90) <= 2.0
    assert abs(fg[4] - fc[4]) <= 1e-3 * abs(fc[4]) and abs(fg[5] - fc[5]) <= 1e-3 * fc[5]
    assert abs((fg[0] + fg[1]) / 2 - 18250.0) < 300.0


@pytest.mark.parametrize("n", [1 << 16, (1 << 16) + 1])
def test_median_cuda_matches_numpy(n):
    from pyp_tpu_torch.ops import pick

    x = np.random.RandomState(n % 7).randn(3, n).astype(np.float32)
    np.testing.assert_array_equal(
        pick.median(torch.from_numpy(x).cuda()).cpu().numpy(),
        np.median(x, axis=-1))


def test_pick_and_hot_pixels_cuda_match_cpu():
    from pyp_tpu_torch.ops import pick

    img, coords = _blobs()
    kw = dict(particle_radius_px=16, max_picks=64, threshold_sigma=2.0,
              edge_px=16)
    c = pick.pick_particles(img, device="cpu", **kw)
    g = pick.pick_particles(img, device="cuda", **kw)

    def as_set(r):
        return {tuple(v) for v in r.coords.cpu().numpy()[r.valid.cpu().numpy()]}

    assert as_set(g) == as_set(c) and len(as_set(g)) >= 16
    n = int(c.valid.sum())
    np.testing.assert_allclose(g.scores.cpu().numpy()[:n], c.scores.numpy()[:n],
                               atol=1e-3)
    frames = np.random.RandomState(2).poisson(3.0, (3, 64, 80)).astype(np.float32)
    frames[1, 10, 10] += 400.0
    t = torch.from_numpy(frames)
    _near(pick.remove_hot_pixels(t.cuda()), pick.remove_hot_pixels(t), 1e-6, 1e-6)


@pytest.mark.parametrize("kw", [dict(), dict(subpixel=True, downsample_to=48)])
def test_extract_particles_cuda_matches_cpu(kw):
    from pyp_tpu_torch.ops import extract

    img, coords = _blobs()
    pos = coords + np.random.RandomState(3).uniform(-0.5, 0.5, coords.shape)
    c = extract.extract_particles(img, pos.astype(np.float32), 64, device="cpu", **kw)
    g = extract.extract_particles(img, pos.astype(np.float32), 64, device="cuda", **kw)
    assert g.is_cuda
    _near(g, c)


def test_process_micrograph_and_extract_stack_cuda_match_cpu(tmp_path):
    from pyp_tpu_torch.io.metadata import ItemMetadata
    from pyp_tpu_torch.pipeline import spr

    frames, _ = _movie(n=256)
    params = schema.defaults()
    params.update(scope_pixel=1.0, detect_rad=16.0, extract_box=32,
                  ctf_tile=128, plot_per_item=False)
    out = {}
    for dev in ("cpu", "cuda"):
        work = tmp_path / dev
        s = spr.process_micrograph({"name": "m", "frames": frames}, params,
                                   work, device=dev)
        assert s["frame_uploads"] == 1
        stack, table = spr.extract_stack(["m"], params, work, device=dev)
        out[dev] = (s, ItemMetadata("m", work).load(), stack, table)
    (sc, mc, stc, tc), (sg, mg, stg, tg) = out["cpu"], out["cuda"]
    assert sg["particles"] == sc["particles"] > 0
    np.testing.assert_allclose(mg["drift"], mc["drift"], atol=1e-2)
    assert {(y, x) for y, x, _ in mg["box"]} == {(y, x) for y, x, _ in mc["box"]}
    assert abs(mg["ctf"][0] - mc["ctf"][0]) <= 50.0
    np.testing.assert_allclose(stg, stc, atol=1e-3 * np.abs(stc).max())
    np.testing.assert_array_equal(tg["original_x_position"],
                                  tc["original_x_position"])



def test_session_daemon_cuda_matches_cpu(tmp_path):
    """The stream daemon on one movie: the card's run gives the CPU run's
    summary and bundle."""
    from pyp_tpu_torch.io import mrc
    from pyp_tpu_torch.io.metadata import ItemMetadata
    from pyp_tpu_torch.stream.daemon import SessionDaemon

    frames, _ = _movie(n=256)
    params = schema.defaults()
    params.update(scope_pixel=1.0, detect_rad=16.0, extract_box=32,
                  ctf_tile=128, plot_per_item=False)
    out = {}
    for dev in ("cpu", "cuda"):
        work = tmp_path / dev
        (work / "in").mkdir(parents=True)
        mrc.write(np.asarray(frames, np.float32), work / "in" / "m.mrc")
        d = SessionDaemon(str(work / "in" / "*.mrc"), dict(params),
                          work_dir=work, poll_interval=0.0, device=dev)
        d.run(max_iterations=1)
        out[dev] = (d.summaries, ItemMetadata("m", work).load())
    (sc, mc), (sg, mg) = out["cpu"], out["cuda"]
    assert len(sg) == len(sc) == 1
    assert sg[0]["particles"] == sc[0]["particles"] > 0
    assert abs(sg[0]["drift_px"] - sc[0]["drift_px"]) < 1e-1
    assert abs(sg[0]["df1"] - sc[0]["df1"]) <= 50.0
    np.testing.assert_allclose(mg["drift"], mc["drift"], atol=1e-2)
    assert {(y, x) for y, x, _ in mg["box"]} == {(y, x) for y, x, _ in mc["box"]}

# ---- ab initio and classification (2D gather / polar E-steps, M-step,
# one 3D classification iteration) ----------------------------------------

def _class_avgs(data):
    """Two class averages: projections of the map at two orientations."""
    R = torch.as_tensor(np.array([[[1, 0, 0], [0, 1, 0], [0, 0, 1]],
                                  [[0, 0, 1], [0, 1, 0], [-1, 0, 0]]],
                                 np.float32))
    F = fs.volume_to_fourier(on(data["volume"], "cpu"))
    return fs.fourier_to_image(fs.project(F, R, N), N).numpy()


def test_align_to_classes_through_the_kernel(data):
    from pyp_tpu_torch.ops import refine2d

    avgs = _class_avgs(data)
    psis = np.arange(0.0, 360.0, 15.0, dtype=np.float32)
    pts = r3.make_mask_points(N, PIXEL, 100.0, 3.0 * PIXEL)
    grid = r3.make_shift_grid(3.0, 1.0)

    def run(dev):
        return refine2d.align_to_classes(
            on(data["stack"], dev), on(data["ctf_params"], dev),
            on(avgs, dev), on(psis, dev), on(pts, dev), on(grid, dev), N,
            PIXEL)

    launches = kernels.shift_scored_match.launches
    out = [x.cpu().numpy() for x in run("cuda")]
    assert kernels.shift_scored_match.launches == launches + 1
    ref = [x.numpy() for x in run("cpu")]
    same = ((out[0] == ref[0]) & (out[1] == ref[1])
            & np.all(np.abs(out[2] - ref[2]) < 1e-3, axis=1))
    assert same.mean() >= 0.95, same
    np.testing.assert_allclose(out[3], ref[3], atol=1e-4)


def test_polar_estep_and_mstep_cuda_match_cpu(data):
    from pyp_tpu_torch.ops import refine2d

    avgs = _class_avgs(data)
    key = (N, PIXEL, 100.0, 3.0 * PIXEL, 3.0, 1.0, 300.0, 2.7, 0.07)
    out = {}
    for dev in ("cuda", "cpu"):
        p2d = refine2d.Polar2D.get(*key, device=dev)
        Xp, wr = p2d.restore(data["stack"], data["ctf_params"])
        k, psi, sh, sc = refine2d.align_to_classes_polar(Xp, wr, avgs, p2d)
        a, o = refine2d.update_class_averages(
            on(data["stack"], dev), on(data["ctf_params"], dev), k, psi, sh,
            torch.ones(len(k), device=dev), N, 2, PIXEL)
        out[dev] = [x.cpu().numpy() for x in (k, psi, sh, sc, a, o)]
    g, c = out["cuda"], out["cpu"]
    same = (g[0] == c[0]) & (np.abs(g[1] - c[1]) < 1e-3)
    assert same.mean() >= 0.9, same
    np.testing.assert_allclose(g[3], c[3], atol=1e-4)
    if same.all():
        np.testing.assert_allclose(g[4], c[4], rtol=0,
                                   atol=1e-4 * np.abs(c[4]).max())
        np.testing.assert_array_equal(g[5], c[5])


def test_classify3d_iteration_cuda_matches_cpu(data):
    from pyp_tpu_torch.pipeline import classify3d

    vol = data["volume"]
    ax = np.arange(N) - N // 2
    r = np.sqrt((ax[None, None, :] - 6) ** 2 + ax[None, :, None] ** 2
                + ax[:, None, None] ** 2)
    refs = [vol, (vol + np.percentile(vol, 99) * np.clip(4.0 - r, 0, 1)
                  ).astype(np.float32)]
    params = schema.defaults()
    params.update({"scope_pixel": PIXEL, "class_num": 2, "refine_rhref": "6",
                   "class_rhcls": 6.0, "refine_rlref": 40.0,
                   "refine_dang": "15", "particle_sym": "C1"})
    occ = np.full((len(data["stack"]), 2), 50.0)
    out = {}
    for dev in ("cuda", "cpu"):
        table = cistem.Table.zeros(len(data["stack"]))
        table["pixel_size"] = np.full(len(data["stack"]), PIXEL)
        table["defocus_1"] = data["ctf_params"][:, 0]
        table["defocus_2"] = data["ctf_params"][:, 1]
        table["defocus_angle"] = data["ctf_params"][:, 2]
        p = truth_poses(data)
        table["phi"], table["theta"], table["psi"] = p[:, 0], p[:, 1], p[:, 2]
        table["y_shift"], table["x_shift"] = p[:, 3] * PIXEL, p[:, 4] * PIXEL
        out[dev] = classify3d.classify3d_iteration(
            data["stack"], table, refs, occ, params, 2, device=dev)
    (tg, rg, og, _), (tc, rc, oc, _) = out["cuda"], out["cpu"]
    assert np.mean(tg["best_2d_class"] == tc["best_2d_class"]) >= 0.9
    for a, b in zip(rg, rc):
        assert np.corrcoef(a.ravel(), b.ravel())[0, 1] >= 0.99


# ---------------------------------------------------------------------------
# tomography: the same small series on the card and on the CPU
# ---------------------------------------------------------------------------

TOMO_SMALL = dict(size=256, pixel=8.0, tilt_step=15.0, shift_px=3.0,
                  n_particles=8, n_beads=6, seed=2)


@pytest.fixture(scope="module")
def tilt_series(tmp_path_factory):
    from pyp_tpu_torch.io import mrc
    from pyp_tpu_torch.tools import e2e_tomo

    d = tmp_path_factory.mktemp("tomo")
    truth, _ = e2e_tomo.write_series(d, device="cpu", **TOMO_SMALL)
    return (mrc.read(d / "ts01.mrc").astype(np.float32),
            np.asarray(truth["angles"], np.float32), truth)


def _both(fn):
    out = {dev: fn(dev) for dev in ("cuda", "cpu")}
    conv = [tuple(x.cpu().numpy() if isinstance(x, torch.Tensor) else
                  np.asarray(x) for x in (o if isinstance(o, tuple) else (o,)))
            for o in (out["cuda"], out["cpu"])]
    return conv


def _close(a, b, rel=1e-4):
    np.testing.assert_allclose(a, b, rtol=rel,
                               atol=rel * max(float(np.abs(b).max()), 1e-30))


def test_tomo_alignment_cuda_matches_cpu(tilt_series):
    """prealign and patch tracks within 1e-2 px, the solved model's axis
    equal."""
    from pyp_tpu_torch.ops import tomo

    tilts, ang, _ = tilt_series
    (g,), (c,) = _both(lambda d: tomo.prealign_tilt_series(tilts, ang, device=d))
    np.testing.assert_allclose(g, c, atol=1e-2)
    centers = np.array([(y, x) for y in (64.0, 128.0, 192.0)
                        for x in (64.0, 128.0, 192.0)], np.float32)
    (tg,), (tc,) = _both(lambda d: tomo.track_patches(
        tilts, c, ang, centers, patch_size=32, device=d))
    np.testing.assert_allclose(tg, tc, atol=1e-2)
    (bg, cg), (bc, cc) = _both(lambda d: tomo.track_beads(
        tilts, c, ang, centers, 3.0, device=d))
    np.testing.assert_allclose(bg, bc, atol=1e-2)
    np.testing.assert_allclose(cg, cc, atol=1e-4)


@pytest.mark.parametrize("what", ["wbp", "halves", "sart", "align", "ctf",
                                  "deconv"])
def test_tomo_reconstruction_cuda_matches_cpu(what, tilt_series):
    """Volumes and corrected tilts atol 1e-4 * max (SART 1e-3: ten
    iterations of sums in another order)."""
    from pyp_tpu_torch.ops import tomo

    tilts, ang, truth = tilt_series
    sh = np.asarray(truth["shifts"], np.float32)
    df = np.asarray(truth["defoci"], np.float32)
    fn = {
        "wbp": lambda d: tomo.wbp_reconstruct(tilts, ang, shifts=sh,
                                              thickness=40, device=d),
        "halves": lambda d: tomo.wbp_reconstruct_halves(
            tilts, ang, shifts=sh, thickness=32, device=d),
        "sart": lambda d: tomo.sart_reconstruct(tilts, ang, shifts=sh,
                                                thickness=32, iterations=3,
                                                device=d),
        "align": lambda d: tomo.align_tilts(tilts, sh, 3.0, device=d),
        "ctf": lambda d: tomo.ctf_correct_tilts(tilts, ang, df, 8.0,
                                                device=d),
        "deconv": lambda d: tomo.ctf_deconvolve(tilts[:8], 35000.0, 8.0,
                                                device=d),
    }[what]
    g, c = _both(fn)
    for a, b in zip(g, c):
        _close(a, b, 1e-3 if what == "sart" else 1e-4)


def test_tomo_picking_and_filters_cuda_match_cpu(tilt_series):
    """Template scores, sphere detection, surface refinement, vesselness
    and the denoisers on one tomogram: maps atol 1e-4 * max, peaks the
    same set, radii within 1e-3 voxel."""
    from pyp_tpu_torch.ops import denoise_classic, filament, tomo
    from pyp_tpu_torch.ops import template_match as tm

    tilts, ang, truth = tilt_series
    vol = tomo.wbp_reconstruct(tilts, ang, thickness=40, device="cpu").numpy()
    tpl = vol[10:18, 10:18, 10:18].copy()
    rots = np.array([[0, 0, 0], [30, 60, 90]], np.float32)
    g, c = _both(lambda d: tm.match_template_3d(vol, tpl, rots, device=d))
    _close(g[0], c[0])
    g, c = _both(lambda d: tm.pick_peaks_3d(torch.as_tensor(vol).to(d), 16, 3))
    assert ({tuple(x) for x in g[0][g[2]]} == {tuple(x) for x in c[0][c[2]]})
    g, c = _both(lambda d: tm.detect_spheres(vol, [4.0, 5.0], 4, device=d))
    np.testing.assert_array_equal(g[0][g[3]], c[0][c[3]])
    g, c = _both(lambda d: tm.refine_surface_sh(vol, [20, 128, 128], 6.0,
                                                n_points=60, l_max=3,
                                                iters=10, device=d))
    np.testing.assert_allclose(g[2], c[2], atol=1e-3)
    for fn in (lambda d: filament.vesselness(vol, 1.5, device=d),
               lambda d: denoise_classic.nlm_denoise_3d(vol, nsearch=5,
                                                        device=d),
               lambda d: denoise_classic.nad_denoise_3d(vol, device=d)):
        g, c = _both(fn)
        _close(g[0], c[0])


def test_process_tilt_series_cuda_matches_cpu(tilt_series, tmp_path):
    """One series through the whole pipeline on each device: the same
    alignment (within 1e-2 px), CTF (within 50 Å), tomogram (atol 1e-3 *
    max) and picks."""
    from pyp_tpu_torch.io import mrc
    from pyp_tpu_torch.io.metadata import ItemMetadata
    from pyp_tpu_torch.pipeline import tomo as tpipe

    tilts, ang, _ = tilt_series
    params = schema.defaults()
    params.update(scope_pixel=8.0, ctf_tile=128, tomo_rec_thickness=160,
                  tomo_ali_patch_size=32, tomo_spk_method="auto",
                  tomo_spk_rad=100.0, plot_per_item=False)
    out = {}
    for dev in ("cuda", "cpu"):
        work = tmp_path / dev
        work.mkdir()
        tpipe.process_tilt_series({"name": "ts", "tilts": tilts,
                                   "angles": ang}, params, work, device=dev)
        out[dev] = (ItemMetadata("ts", work, mode="tomo").load(),
                    mrc.read(work / "ts.rec.mrc"))
    (mg, rg), (mc, rc) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(mg["xf"], mc["xf"], atol=1e-2)
    np.testing.assert_allclose(mg["ctf"][:, :2], mc["ctf"][:, :2], atol=50.0)
    _close(rg, rc, 1e-3)
    assert {tuple(r[:3]) for r in mg["box"]} == {tuple(r[:3]) for r in mc["box"]}


@pytest.fixture(scope="module")
def csp_series():
    """A 7-tilt series of 160² with 6 particles of a random box-24 map,
    made with the port's own CPU projection (no JAX on the card's
    machine), and two perturbed starts."""
    from pyp_tpu_torch.core.filters import soft_spherical_mask
    from pyp_tpu_torch.ops import csp

    rng = np.random.RandomState(0)
    n, ny, T, P = 24, 160, 7, 6
    vol = rng.randn(n, n, n).astype(np.float32)
    vol *= soft_spherical_mask(n, n * 0.33, 2.0).numpy()
    vol = bandlimit3(vol, 6) * 20.0
    angles = np.arange(-45.0, 46.0, 15.0, dtype=np.float32)
    true = csp.make_params(
        angles, np.full(T, 2.0, np.float32),
        rng.uniform(-3, 3, (T, 2)).astype(np.float32),
        rng.uniform(0, 360, (P, 3)).astype(np.float32),
        np.stack([rng.uniform(-10, 10, P), rng.uniform(-50, 50, P),
                  rng.uniform(-50, 50, P)], 1).astype(np.float32),
        device="cpu")
    Fv = fs.volume_to_fourier(torch.as_tensor(vol))
    R_eff = csp.effective_rotations(true)
    pos = csp.project_positions(true).numpy()
    images = np.zeros((T, ny, ny), np.float32)
    for t in range(T):
        projs = fs.fourier_to_image(fs.project(Fv, R_eff[t], n), n).numpy()
        for p in range(P):
            iy, ix = np.round(pos[t, p] + ny // 2).astype(int)
            images[t, iy - n // 2:iy + n // 2, ix - n // 2:ix + n // 2] += projs[p]
    images += 0.05 * np.abs(images).max() * rng.randn(*images.shape).astype(np.float32)
    starts = []
    for amp in (1.0, 2.0):
        starts.append(true._replace(
            tilt_shifts=true.tilt_shifts + torch.as_tensor(
                rng.uniform(-amp, amp, (T, 2)).astype(np.float32)),
            particle_eulers=true.particle_eulers + torch.as_tensor(
                rng.uniform(-3 * amp, 3 * amp, (P, 3)).astype(np.float32))))
    return vol, images, np.full((T, 2), 15000.0, np.float32), starts


def bandlimit3(vol, kmax):
    n = vol.shape[-1]
    k = np.fft.fftfreq(n) * n
    r = np.sqrt(k[:, None, None] ** 2 + k[None, :, None] ** 2
                + np.fft.rfftfreq(n)[None, None, :] ** 2 * n * n)
    return np.fft.irfftn(np.fft.rfftn(vol) * (r < kmax), s=vol.shape).astype(
        np.float32)


def test_csp_refine_batch_cuda_matches_cpu(csp_series):
    """Two series through the schedule (a mode-3 grid search, modes 3 and
    1, 3 steps each): vectorized on the card, sequential on the CPU."""
    from pyp_tpu_torch.ops import csp
    from pyp_tpu_torch.ops.refine3d import make_mask_points

    vol, images, defocus, starts = csp_series
    n, T = 24, images.shape[0]
    mask = make_mask_points(n, PIXEL, 60.0, 2.5 * PIXEL)
    offs, spin = csp.build_mode_offsets((3, 1), {3: 1.0}, 3)

    def run(dev, vmap):
        prep = [csp.prepare_series_windows(images, csp.CspParams(
            *(x.to(dev) for x in s)), n, mask, device=dev) for s in starts]
        pb = csp.CspParams(*(torch.stack([getattr(s, f) for s in starts]).to(dev)
                             for f in csp.CspParams._fields))
        return csp.csp_refine_batch(
            pb, torch.stack([x[0] for x in prep]),
            on(np.stack([x[1] for x in prep]), dev),
            on(np.stack([defocus] * 2), dev), on(mask, dev),
            fs.volume_to_fourier(on(vol, dev)), torch.ones(2, T, device=dev),
            on(np.stack([x[2] for x in prep]), dev), offs, spin, (3, 1), n,
            PIXEL, iters_per_mode=3, series_vmap=vmap)

    g, c = run("cuda", True), run("cpu", False)
    for a, b in zip(g[0], c[0]):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-3)
    np.testing.assert_allclose(g[1].cpu().numpy(), c[1].numpy(), atol=1e-4)
    np.testing.assert_allclose(g[2].cpu().numpy(), c[2].numpy(), atol=1e-4)


def test_csp_classify_cuda_matches_cpu(csp_series):
    """csp_classify of the series against its own map and a 0.8 : 0.2 mix
    of it with another map (occupancies spread between 30 and 92%): on the
    card through the gather and score kernels, one forward each per tilt
    and class, against the plain chain on the CPU."""
    from pyp_tpu_torch.config.params import defaults
    from pyp_tpu_torch.core.filters import soft_spherical_mask
    from pyp_tpu_torch.pipeline import csp as pipe

    vol, images, defocus, starts = csp_series
    n, T = 24, images.shape[0]
    rng = np.random.RandomState(7)
    other = rng.randn(n, n, n).astype(np.float32)
    other = bandlimit3(other * soft_spherical_mask(n, n * 0.33, 2.0).numpy(),
                       6) * 20.0
    refs = [vol, (0.8 * vol + 0.2 * other).astype(np.float32)]
    p = defaults()
    p.update({"scope_pixel": PIXEL, "csp_box": n, "csp_rlref": 60.0,
              "csp_rhref": "5"})
    items = [{"name": "a", "tilts": images, "params": starts[0],
              "defocus": defocus}]
    launches = (kernels.csp_slice_gather.launches, kernels.csp_score.launches)
    g = pipe.csp_classify(items, p, refs, device="cuda")
    assert (kernels.csp_slice_gather.launches - launches[0],
            kernels.csp_score.launches - launches[1]) == (2 * T, 2 * T)
    c = pipe.csp_classify(items, p, refs, device="cpu")
    np.testing.assert_allclose(g[1][0], c[1][0], rtol=0, atol=1e-3)
    for a, b in zip(g[0], c[0]):
        # close_maps' rule: below 0.85 Nyquist, 3e-3 x max
        a, b = (bandlimit3(x.volume.cpu().numpy(), 0.85 * n / 2)
                for x in (a, b))
        np.testing.assert_allclose(a, b, rtol=0, atol=3e-3 * np.abs(b).max())


def test_accumulate_matrices_cuda_matches_cpu():
    from pyp_tpu_torch.core.geometry import euler_to_matrix

    rng = np.random.RandomState(3)
    B, n = 16, 24
    wins = bandlimit(rng.randn(B, n, n).astype(np.float32))
    eul = torch.as_tensor(rng.uniform(0, 360, (B, 3)).astype(np.float32))
    R = euler_to_matrix(eul[:, 0], eul[:, 1], eul[:, 2]).numpy()
    args = (wins, R, rng.uniform(-2, 2, (B, 2)).astype(np.float32),
            rng.uniform(14000, 16000, B).astype(np.float32),
            np.arange(B) % 2, np.ones(B, np.float32))

    def run(dev):
        acc = rec.accumulate_matrices(*(on(a, dev) for a in args), n, PIXEL)
        return rec.finalize(acc, n)

    g, c = run("cuda"), run("cpu")
    for a, b in ((g.half1, c.half1), (g.half2, c.half2)):
        _close(a.cpu().numpy(), b.numpy(), 1e-4)


def test_sva_score_block_cuda_matches_cpu():
    from pyp_tpu_torch.ops import sva

    rng = np.random.RandomState(4)
    n = 16
    subs = rng.randn(5, n, n, n).astype(np.float32)
    bank = rng.randn(6, n, n, n).astype(np.float32)
    bank /= np.sqrt((bank ** 2).sum((1, 2, 3), keepdims=True))
    norm = np.sqrt((subs ** 2).sum((1, 2, 3))).astype(np.float32)

    def run(dev):
        return sva._score_block(torch.fft.rfftn(on(subs, dev), dim=(-3, -2, -1)),
                                on(bank, dev), on(norm, dev), 3)

    g, c = run("cuda"), run("cpu")
    np.testing.assert_array_equal(g[1].cpu().numpy(), c[1].numpy())
    np.testing.assert_array_equal(g[2].cpu().numpy(), c[2].numpy())
    np.testing.assert_allclose(g[0].cpu().numpy(), c[0].numpy(), atol=1e-4)


def test_refine_trajectories_cuda_matches_cpu(data):
    from pyp_tpu_torch.ops import polish

    rng = np.random.RandomState(5)
    P, F = 8, 5
    frames = (np.repeat(data["stack"][:P, None], F, 1)
              + 0.1 * rng.randn(P, F, N, N)).astype(np.float32)
    poses = truth_poses(data)[:P]
    pts = r3.make_mask_points(N, PIXEL, 100.0, 2.5 * PIXEL)

    def run(dev):
        return polish.refine_trajectories(
            frames, poses, data["ctf_params"][:P],
            fs.volume_to_fourier(on(data["volume"], dev)), pts, N, PIXEL,
            iters=6, device=dev)

    g, c = run("cuda"), run("cpu")
    np.testing.assert_allclose(g[0].cpu().numpy(), c[0].numpy(), atol=1e-3)


# ---------------------------------------------------------------- models
# The convolutions run at cuDNN's default precision (TF32 on Hopper), the
# dense layers in FP32: U-Net and encoder outputs are held to 1e-2 x max,
# the heterogeneity loss to 1e-3 relative and its gradients to 1e-2 x max.
# One Adam step moves each parameter by about lr * sign(gradient), which
# TF32 flips where a gradient is float noise (a bias in front of a
# GroupNorm), so the step is held on 95% of the kernel elements within
# 0.1 lr and the loss within 1e-3.

def _unet_pair(features=(8, 16, 32)):
    from pyp_tpu_torch.models import unet

    nets = []
    for dev in ("cuda", "cpu"):
        nets.append(unet.init_params(unet.UNet2D(features), 3).to(dev).eval())
    return nets


def test_unet_forward_cuda_matches_cpu():
    g, c = _unet_pair()
    x = np.random.RandomState(6).randn(3, 1, 64, 48).astype(np.float32)
    with torch.no_grad():
        a, b = g(on(x, "cuda")).cpu().numpy(), c(on(x, "cpu")).numpy()
    np.testing.assert_allclose(a, b, atol=1e-2 * np.abs(b).max())


def test_train_picker_one_adam_step_cuda_matches_cpu():
    from pyp_tpu_torch.models import picker

    rng = np.random.RandomState(7)
    mics = [rng.randn(96, 96).astype(np.float32) for _ in range(2)]
    coords = [np.array([[30, 40], [60, 70]]), np.array([[20, 20]])]
    lr = 3e-4
    runs = [picker.train_picker(mics, coords, 4.0, patch=32, steps=1,
                                batch=4, lr=lr, features=(8, 16, 32),
                                device=dev) for dev in ("cuda", "cpu")]
    moved = []
    for k, v in runs[1].params.items():
        if k.endswith("kernel"):
            moved.append(np.abs(runs[0].params[k].numpy() - v.numpy()).ravel())
    moved = np.concatenate(moved)
    assert np.mean(moved <= 0.1 * lr) >= 0.95 and moved.max() <= 2.5 * lr


def test_infer_heatmap_batched_cuda_matches_cpu():
    from pyp_tpu_torch.models import picker, unet

    net = unet.init_params(unet.UNet2D((8, 16, 32)), 4)
    model = picker.PickerModel({k: v for k, v in net.state_dict().items()},
                               32, 4.0)
    mic = np.random.RandomState(8).randn(200, 168).astype(np.float32)
    a = picker.infer_heatmap(model, mic, features=(8, 16, 32), device="cuda")
    b = picker.infer_heatmap(model, mic, features=(8, 16, 32), device="cpu")
    np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-2)


def test_encoder3d_cuda_matches_cpu():
    from pyp_tpu_torch.models import miner, unet

    enc = unet.init_params(miner.Encoder3D(embed_dim=16), 5).eval()
    x = np.random.RandomState(9).randn(40, 1, 16, 16, 16).astype(np.float32)
    with torch.no_grad():
        a = enc.to("cuda")(on(x, "cuda")).cpu().numpy()
        b = enc.to("cpu")(on(x, "cpu")).numpy()
    np.testing.assert_allclose(a, b, atol=1e-2)


def test_heterogeneity_loss_cuda_matches_cpu(data):
    from pyp_tpu_torch.models import heterogeneity as het
    from pyp_tpu_torch.models import unet

    mask_pts = r3.make_mask_points(N, PIXEL, 60.0, 2.5 * PIXEL)
    eps = np.random.RandomState(10).randn(8, 4).astype(np.float32)
    out = []
    for dev in ("cuda", "cpu"):
        enc = unet.init_params(het.Encoder(4, N), 1).to(dev)
        dec = unet.init_params(het.SliceDecoder(4, 32), 2).to(dev)
        xv, ctf, coords = het._slice_data(
            on(data["stack"][:8], dev), on(truth_poses(data)[:8], dev),
            on(data["ctf_params"][:8], dev), on(mask_pts, dev), N, PIXEL,
            300.0, 2.7, 0.07)
        x = on(het._standardized(data["stack"][:8]), dev)[:, None]
        loss = het._het_loss(enc, dec, x, coords, ctf, xv, on(eps, dev), 1e-3)
        loss.backward()
        grads = [p.grad.cpu().numpy() for m in (enc, dec)
                 for p in m.parameters()]
        out.append((loss.item(), grads))
    (lg, gg), (lc, gc) = out
    np.testing.assert_allclose(lg, lc, rtol=1e-3)
    for a, b in zip(gg, gc):
        np.testing.assert_allclose(a, b, atol=1e-2 * np.abs(b).max() + 1e-12)
