"""The port's CUDA path against its own CPU path, module by module: every
layer of the gather-engine slice (global search through the CUDA kernel,
the autograd polish, insertion with atomics, the refine loop) gives on a
card what the CPU path, held to the JAX package by the other
test_torch_* files, gives on the same seeded inputs.

All tests here need a card and no JAX; on a CUDA machine they run with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels.py tests/test_torch_cuda.py

Tolerances (box 32, 2 Å/px, 24 particles): global_search candidates the
same on >= 95% of (particle, k) slots, top scores within 1e-4; local
polish >= 95% of particles within 0.05° and 0.01 px; maps atol 1e-4 *
max|map| and FSC atol 1e-3 (insertion sums in another order on the card);
one refine_loop iteration >= 90% of poses within 1° and map cc >= 0.99.
"""

import numpy as np
import pytest
import torch

from pyp_tpu.config import schema
from pyp_tpu.io import cistem
from pyp_tpu_torch.ops import fourier_slice as fs
from pyp_tpu_torch.ops import kernels
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
