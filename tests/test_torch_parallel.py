"""The port's multi-rank path on the CPU: one 2-rank gloo group (two
subprocesses on a free port, as tests/test_bridge.py starts its JAX
ranks; the ranks import only torch and the port) runs every function of
pyp_tpu_torch/parallel once on seeded inputs at box 32 — an odd particle
count, so the padding is exercised, and 3 CSP series — then
`cli.main(["refine", ...])` for 2 FRM iterations on 48 particles. Each
rank saves what it got; rank 1 works in a copy of the project, which must
stay as it was (rank 0 alone writes).

Every result is held to the port's single-device function and to the
JAX function on a 2-device mesh of the virtual CPU mesh
(tests/conftest.py); `sharded_refine_step` runs on make_mesh(2, model=2)
in both packages. Tolerances: the pose search as FRM's sharded/single
check (scores rtol 1e-5 / atol 1e-6, poses rtol 1e-4 / atol 1e-3,
__graft_entry__.py:209-216) against one device, and against JAX as
tests/test_torch_refine3d.py's refine_batch check; reconstructions within
2e-4 of the map's largest value (__graft_entry__.py:228-232);
accumulators as test_torch_csp.py::test_accumulate_matrices_matches
against JAX and within 1e-5 of the largest value against one device;
`sharded_refine_step` as tests/test_parallel.py:40-43; the CSP batch as
test_torch_csp_search.py's (parameters 1e-3, scores 1e-5); the 2-rank loop
within test_torch_refine_pipeline.py's parity tolerances of the
single-rank loop. The IEWALD 2 insertions patch the port's
`ref_amplitude` to 1, in the ranks and here (the JAX package inserts the
reference unscaled)."""

import json
import os
import shutil
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyp_tpu.io import cistem as jcistem
from pyp_tpu.io import mrc as jmrc
from pyp_tpu.ops import csp as jcsp
from pyp_tpu.ops import fourier_slice as jfs
from pyp_tpu.parallel import spmd as jspmd
from pyp_tpu_torch import cli as tcli
from pyp_tpu_torch.core.filters import lowpass_filter_3d, soft_spherical_mask
from pyp_tpu_torch.core.geometry import euler_to_matrix
from pyp_tpu_torch.ops import csp as tcsp
from pyp_tpu_torch.ops import fourier_slice as tfs
from pyp_tpu_torch.ops import reconstruct as trec
from pyp_tpu_torch.ops import refine3d as tr3
from pyp_tpu_torch.parallel import multihost
from tests.test_csp import ANGLES, NBOX, NX, NY, P, T
from tests.test_refine3d import N, PIXEL
from tests.test_torch_csp import agree_off_the_ambiguous_voxels
from tests.test_torch_refine3d import rot_diff_deg

REPO = Path(__file__).resolve().parent.parent
B = 15                    # odd: the 2-rank split pads one row
SEARCH = dict(angular_step=30.0, psi_step=30.0, low_res=100.0,
              high_res_search=3.0 * PIXEL, high_res_refine=2.5 * PIXEL,
              shift_extent=2.0, shift_step=2.0, topk=2, local_iters=6)
LBLUR = ((-4.0, 0.0, 4.0), (0.25, 0.5, 0.25))
REC = dict(crop_to=16, iewald=2, batch=4)
REFINE_ARGV = ["refine", "-refine_engine", "frm", "-refine_maxiter", "2",
               "-refine_rhref", "8:6", "-refine_dang", "12",
               "-refine_psi_step", "10", "-refine_searchx", "3",
               "-refine_shift_step", "1.5", "-refine_rlref", "100",
               "-refine_frm_cone", "15", "-refine_goldstandard",
               "-scope_pixel", str(PIXEL), "-no_plot_per_item"]
CSP_MODES, CSP_GRID, CSP_ITERS = (3, 1), {3: 1.0}, 3

_RANK = r"""
import os, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(2)
import torch.distributed as dist
from pyp_tpu_torch import cli, parallel
from pyp_tpu_torch.ops import csp, fourier_slice as fs
from pyp_tpu_torch.parallel import multihost
# the JAX package inserts the IEWALD 2 reference unscaled
fs.ref_amplitude = lambda pred, F: torch.ones(F.shape[0])
d, out_dir, root = dict(np.load(sys.argv[2])), sys.argv[3], sys.argv[4]
cfg = __import__("json").loads(sys.argv[5])
assert parallel.init_distributed(device="cpu")
rank = dist.get_rank()
t = torch.as_tensor
out = {}
mesh = parallel.pipeline_mesh({}, device="cpu")
assert (mesh.shape, mesh.backend) == ({"data": 2, "model": 1}, "gloo")
res = parallel.sharded_refine_batch(mesh, d["stack"], d["ctf"], d["vol"],
                                    cfg["pixel"], **cfg["search"])
out.update({f"rb_{k}": v for k, v in res._asdict().items()})
acc = parallel.sharded_accumulate(
    mesh, d["stack"], d["poses"], d["ctf"], d["subset"], d["weights"],
    cfg["n"], cfg["pixel"], doses=d["doses"], lblur=cfg["lblur"], iewald=2,
    ref_fourier=fs.volume_to_fourier(t(d["vol"]), pad=2))
out.update({f"acc_{k}": v for k, v in acc._asdict().items()})
acc = parallel.sharded_accumulate_matrices(
    mesh, d["wins"], d["R"], d["sh"], d["df"], d["subset"], d["weights"],
    cfg["n"], cfg["pixel"])
out.update({f"mat_{k}": v for k, v in acc._asdict().items()})
rec = parallel.reconstruct_sharded(
    mesh, d["stack"], d["poses"], d["ctf"], cfg["pixel"],
    subset=d["subset"], ref_volume=d["vol"], **cfg["rec"])
out.update({f"rec_{k}": v for k, v in rec._asdict().items()})
acc = parallel.sharded_reconstruct(mesh, d["stack16"], d["poses16"],
                                   d["ctf16"], cfg["pixel"])
out.update({f"sr_{k}": v for k, v in acc._asdict().items()})
offs, spin = csp.build_mode_offsets(cfg["csp_modes"],
                                    {int(k): v for k, v in cfg["csp_grid"].items()}, 3)
pb = csp.CspParams(*(t(d[f"csp_p{i}"]) for i in range(6)))
refined, ms, ps = parallel.csp_refine_batch_sharded(
    mesh, pb, t(d["csp_xv"]), t(d["csp_wc"]), t(d["csp_df"]),
    t(d["csp_mask"]), fs.volume_to_fourier(t(d["csp_vol"])), t(d["csp_tw"]),
    t(d["csp_va"]), offs, spin, tuple(cfg["csp_modes"]), cfg["csp_n"],
    cfg["pixel"], iters_per_mode=cfg["csp_iters"])
out.update({f"csp_p{i}": v for i, v in enumerate(refined)})
out.update(csp_ms=ms, csp_ps=ps)
m2 = parallel.make_mesh(2, model=2, device="cpu")
poses, scores = parallel.sharded_refine_step(
    m2, d["step_stack"], d["step_ctf"], d["vol"], d["step_init"],
    cfg["pixel"], low_res=40.0, high_res=2.5 * cfg["pixel"], iters=6)
out.update(step_poses=poses, step_scores=scores)
lo, hi = (0, 10) if rank == 0 else (10, len(d["stack"]))
out["range"] = np.array(multihost.process_range(len(d["stack"])))
rec = multihost.distributed_reconstruct(
    d["stack"][lo:hi], d["poses"][lo:hi], d["ctf"][lo:hi], cfg["pixel"],
    subset=d["subset"][lo:hi], batch=4, device="cpu")
out["dist_volume"] = rec.volume
os.chdir(os.path.join(root, f"rank{rank}"))
out["refine_rc"] = np.array(cli.main(cfg["refine_argv"], device="cpu"))
np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
         **{k: np.asarray(v) for k, v in out.items()})
dist.destroy_process_group()
"""


def t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _volume(n, radius, edge, seed, scale):
    """A soft-masked, low-passed random volume (tests/test_refine3d.py's
    make_volume, in torch ops)."""
    vol = np.random.RandomState(seed).randn(n, n, n).astype(np.float32)
    vol = t(vol) * soft_spherical_mask(n, n * radius, edge)
    return (lowpass_filter_3d(vol, PIXEL, 3.0 * PIXEL) * scale).numpy()


def _particles(vol, n_particles, noise=0.1, shift_max=2.0, seed=1):
    """CTF-modulated, shifted projections of `vol` with noise
    (tests/test_refine3d.py's make_particles, in torch ops)."""
    rng = np.random.RandomState(seed)
    phi = rng.uniform(0, 360, n_particles).astype(np.float32)
    theta = np.degrees(np.arccos(rng.uniform(-1, 1, n_particles))).astype(np.float32)
    psi = rng.uniform(0, 360, n_particles).astype(np.float32)
    shifts = rng.uniform(-shift_max, shift_max, (n_particles, 2)).astype(np.float32)
    df = rng.uniform(12000, 25000, n_particles).astype(np.float32)
    ctf = np.stack([df + 500, df - 500, np.full(n_particles, 30.0),
                    np.zeros(n_particles)], axis=1).astype(np.float32)
    R = euler_to_matrix(t(phi), t(theta), t(psi))
    F = tfs.project(tfs.volume_to_fourier(t(vol)), R, N)
    F = F * trec._ctf_grids(N, PIXEL, t(ctf), 300.0, 2.7, 0.07)
    imgs = tfs.fourier_to_image(trec._shift_correct(F, t(shifts), N), N).numpy()
    imgs += noise * np.abs(imgs).max() * rng.randn(*imgs.shape).astype(np.float32)
    poses = np.stack([phi, theta, psi, -shifts[:, 0], -shifts[:, 1]], 1)
    return imgs, ctf, poses


def _tilt_series(vol, seed=1, noise=0.05):
    """A tilt series of P particles with a depth-dependent CTF
    (tests/test_csp.py's make_tilt_series, in torch ops, windows placed at
    the rounded positions)."""
    rng = np.random.RandomState(seed)
    true = tcsp.make_params(
        ANGLES, np.full(T, 2.0, np.float32),
        rng.uniform(-3, 3, (T, 2)).astype(np.float32),
        rng.uniform(0, 360, (P, 3)).astype(np.float32),
        np.stack([rng.uniform(-10, 10, P), rng.uniform(-50, 50, P),
                  rng.uniform(-50, 50, P)], 1).astype(np.float32),
        device="cpu")
    Fv = tfs.volume_to_fourier(t(vol))
    pos = tcsp.project_positions(true).numpy()
    depth = tcsp.particle_depth(true)
    ky = (np.fft.fftfreq(NBOX) * NBOX).astype(np.float32)
    kx = np.arange(NBOX // 2 + 1, dtype=np.float32)
    grid = t(np.stack(np.meshgrid(ky, kx, indexing="ij"), -1))
    images = np.zeros((T, NY, NX), dtype=np.float32)
    for i, R in enumerate(tcsp.effective_rotations(true)):
        df = (15000.0 + depth[i] * PIXEL)[:, None, None]
        c = tr3._ctf_at_points(grid[None], NBOX, PIXEL, df, df, 0.0, 300.0,
                               2.7, 0.07, 0.0)
        projs = tfs.fourier_to_image(tfs.project(Fv, R, NBOX) * c,
                                     NBOX).numpy()
        for j in range(P):
            iy, ix = np.round(pos[i, j] + [NY // 2, NX // 2]).astype(int)
            images[i, iy - NBOX // 2:iy + NBOX // 2,
                   ix - NBOX // 2:ix + NBOX // 2] += projs[j]
    images += noise * np.abs(images).max() * rng.randn(*images.shape).astype(np.float32)
    return true, images


@pytest.fixture(scope="module")
def data():
    vol = _volume(N, 0.35, 3.0, 0, 10.0)
    imgs, ctf, poses = _particles(vol, 16)
    rng = np.random.RandomState(7)
    eul = rng.uniform(0, 360, (B, 3)).astype(np.float32)
    step_init = poses + np.concatenate(
        [rng.uniform(-5, 5, (16, 3)), np.zeros((16, 2))], 1).astype(np.float32)
    d = dict(vol=vol, stack=imgs[:B], ctf=ctf[:B], poses=poses[:B],
             subset=(np.arange(B) % 2).astype(np.int32),
             weights=rng.uniform(0.5, 1.0, B).astype(np.float32),
             doses=rng.uniform(0.0, 40.0, B).astype(np.float32),
             wins=rng.randn(B, N, N).astype(np.float32),
             R=euler_to_matrix(*t(eul).T).numpy(),
             sh=rng.uniform(-2, 2, (B, 2)).astype(np.float32),
             df=rng.uniform(14000, 16000, B).astype(np.float32),
             stack16=imgs, poses16=poses, ctf16=ctf, step_stack=imgs,
             step_ctf=ctf, step_init=step_init)
    # three CSP series of different start errors
    cvol = _volume(NBOX, 0.33, 2.0, 0, 20.0)
    true, images = _tilt_series(cvol)
    mask = tr3.make_mask_points(NBOX, PIXEL, 60.0, 2.5 * PIXEL)
    series = []
    for s, amp in enumerate((0.5, 1.5, 3.0)):
        r = np.random.RandomState(20 + s)
        p = true._replace(
            tilt_shifts=true.tilt_shifts + t(r.uniform(-amp, amp, (T, 2)).astype(np.float32)),
            particle_eulers=true.particle_eulers + t(r.uniform(-2 * amp, 2 * amp, (P, 3)).astype(np.float32)))
        xv, wc, va = tcsp.prepare_series_windows(t(images), p, NBOX, t(mask),
                                                 device="cpu")
        series.append((p, xv, wc, va))
    for i in range(6):
        d[f"csp_p{i}"] = np.stack([x[0][i].numpy() for x in series])
    for key, i in (("csp_xv", 1), ("csp_wc", 2), ("csp_va", 3)):
        d[key] = np.stack([np.asarray(x[i]) for x in series])
    d.update(csp_df=np.full((3, T, 2), 15000.0, np.float32),
             csp_tw=np.ones((3, T), np.float32), csp_mask=mask, csp_vol=cvol)
    return d


def _refine_project(path):
    """stack.mrc, stack.cistem and initial_model.mrc of 48 particles, as
    test_torch_refine_pipeline.py's problem builds them."""
    vol = _volume(N, 0.35, 3.0, 2, 10.0)
    imgs, cp, _ = _particles(vol, 48, seed=5)
    table = jcistem.Table.zeros(48)
    table["position_in_stack"] = np.arange(1, 49)
    table["pixel_size"] = np.full(48, PIXEL)
    table["defocus_1"], table["defocus_2"] = cp[:, 0], cp[:, 1]
    table["defocus_angle"] = cp[:, 2]
    table["occupancy"] = np.full(48, 100.0)
    path.mkdir(parents=True)
    jmrc.write(imgs, path / "stack.mrc", pixel_size=PIXEL)
    jcistem.write_parameters(table, path / "stack.cistem")
    jmrc.write(lowpass_filter_3d(t(vol), PIXEL, 12.0).numpy(),
               path / "initial_model.mrc", pixel_size=PIXEL)


class Group:
    """The 2-rank group, started at once; `get()` waits for its results."""

    def __init__(self, tmp, data):
        self.tmp = tmp
        np.savez(tmp / "data.npz", **data)
        root = tmp / "projects"
        _refine_project(root / "rank0")
        shutil.copytree(root / "rank0", root / "rank1")
        shutil.copytree(root / "rank0", tmp / "single")
        self.before = sorted(p.name for p in (root / "rank1").rglob("*"))
        (tmp / "rank.py").write_text(_RANK)
        cfg = dict(pixel=PIXEL, n=N, search=SEARCH, lblur=LBLUR, rec=REC,
                   csp_modes=CSP_MODES, csp_grid=CSP_GRID, csp_n=NBOX,
                   csp_iters=CSP_ITERS, refine_argv=REFINE_ARGV)
        with socket.socket() as s:
            s.bind(("", 0))
            port = s.getsockname()[1]
        env = {k: v for k, v in os.environ.items()
               if k not in ("PYP_TPU_DISABLE_SPMD", "PYP_TPU_WORKER")}
        env.update(PYP_TPU_COORDINATOR=f"localhost:{port}",
                   PYP_TPU_NUM_PROCS="2", OMP_NUM_THREADS="2")
        self.procs = [subprocess.Popen(
            [sys.executable, str(tmp / "rank.py"), str(REPO),
             str(tmp / "data.npz"), str(tmp), str(root), json.dumps(cfg)],
            env={**env, "PYP_TPU_PROC_ID": str(rank)},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for rank in (0, 1)]
        self.out = None

    def get(self):
        if self.out is None:
            logs = [p.communicate(timeout=600)[0].decode()
                    for p in self.procs]
            assert all(p.returncode == 0 for p in self.procs), \
                "\n".join(logs)
            self.out = [dict(np.load(self.tmp / f"rank{r}.npz"))
                        for r in (0, 1)]
        return self.out


@pytest.fixture(scope="module")
def group(tmp_path_factory, data):
    g = Group(tmp_path_factory.mktemp("group"), data)
    yield g
    for p in g.procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


def _jax_refs(d):
    """The JAX package's functions on 2-device meshes of the virtual CPU
    mesh, by name."""
    m = jspmd.make_mesh(2)
    offs, spin = jcsp.build_mode_offsets(CSP_MODES, CSP_GRID, 3)
    j = {k: jnp.asarray(v) for k, v in d.items() if k.startswith("csp_")}
    return {
        "rb": lambda: jspmd.sharded_refine_batch(
            m, d["stack"], d["ctf"], d["vol"], PIXEL, **SEARCH),
        "acc": lambda: jspmd.sharded_accumulate(
            m, d["stack"], d["poses"], d["ctf"], d["subset"], d["weights"],
            N, PIXEL, doses=d["doses"], lblur=LBLUR, iewald=2,
            ref_fourier=jfs.volume_to_fourier(jnp.asarray(d["vol"]), pad=2)),
        "mat": lambda: jspmd.sharded_accumulate_matrices(
            m, d["wins"], d["R"], d["sh"], d["df"], d["subset"],
            d["weights"], N, PIXEL),
        "rec": lambda: jspmd.reconstruct_sharded(
            m, d["stack"], d["poses"], d["ctf"], PIXEL, subset=d["subset"],
            ref_volume=d["vol"], **REC),
        "sr": lambda: jspmd.sharded_reconstruct(
            m, d["stack16"], d["poses16"], d["ctf16"], PIXEL),
        "csp": lambda: jspmd.csp_refine_batch_sharded(
            m, jcsp.CspParams(*(j[f"csp_p{i}"] for i in range(6))),
            j["csp_xv"], j["csp_wc"], j["csp_df"], j["csp_mask"],
            jfs.volume_to_fourier(j["csp_vol"]), j["csp_tw"], j["csp_va"],
            offs, spin, CSP_MODES, NBOX, PIXEL, iters_per_mode=CSP_ITERS),
        "step": lambda: jspmd.sharded_refine_step(
            jspmd.make_mesh(2, model=2), d["step_stack"], d["step_ctf"],
            d["vol"], d["step_init"], PIXEL, low_res=40.0,
            high_res=2.5 * PIXEL, iters=6),
    }


@pytest.fixture(scope="module")
def jax_refs(data):
    """The JAX references, computed on three threads while the group runs
    (their compilations dominate this file's time)."""
    with ThreadPoolExecutor(3) as pool:
        yield {k: pool.submit(f) for k, f in _jax_refs(data).items()}


def _ranks(group, key):
    """Rank 0's result, after checking rank 1 holds the same."""
    r0, r1 = (o[key] for o in group.get())
    np.testing.assert_array_equal(r0, r1)
    return r0


def test_sharded_refine_batch(data, group, jax_refs):
    """The global + local search split over the ranks (on the CPU the
    kernel's wrapper takes its plain version): the poses are one device's
    and JAX's."""
    single = tr3.refine_batch(data["stack"], data["ctf"], data["vol"], PIXEL,
                              device="cpu", **SEARCH)
    jres = jax_refs["rb"].result()
    fields = ("phi", "theta", "psi", "shift_y", "shift_x")
    p = np.stack([_ranks(group, f"rb_{f}") for f in fields], 1)
    score = _ranks(group, "rb_score")
    np.testing.assert_allclose(score, single.score.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(
        p, np.stack([getattr(single, f).numpy() for f in fields], 1),
        rtol=1e-4, atol=1e-3)
    jp = np.stack([np.asarray(getattr(jres, f)) for f in fields], 1)
    ok = (rot_diff_deg(p, jp) < 0.5) & (np.abs(p[:, 3:] - jp[:, 3:]).max(1)
                                        < 0.05)
    assert ok.mean() >= 0.9, (rot_diff_deg(p, jp), p[:, 3:] - jp[:, 3:])
    np.testing.assert_allclose(score[ok], np.asarray(jres.score)[ok],
                               atol=0.5)


def _same_acc(group, prefix, single, jax_acc):
    for f, a, b in zip(trec.Accumulators._fields, single, jax_acc):
        got = _ranks(group, f"{prefix}_{f}")
        a = a.numpy()
        np.testing.assert_allclose(got, a, rtol=1e-5,
                                   atol=1e-5 * np.abs(a).max())
        agree_off_the_ambiguous_voxels(got, np.asarray(b))


@pytest.fixture
def unit_ref_amplitude(monkeypatch):
    monkeypatch.setattr(tfs, "ref_amplitude",
                        lambda pred, F: torch.ones(F.shape[0]))


def test_sharded_accumulate(data, group, jax_refs, unit_ref_amplitude):
    """Doses, likelihood blurring and IEWALD 2 against a reference: padded
    rows weigh nothing."""
    d = data
    single = trec.accumulate(
        t(d["stack"]), t(d["poses"]), t(d["ctf"]), t(d["subset"]).long(),
        t(d["weights"]), N, PIXEL, doses=d["doses"], lblur=LBLUR, iewald=2,
        ref_fourier=tfs.volume_to_fourier(t(d["vol"]), pad=2))
    _same_acc(group, "acc", single, jax_refs["acc"].result())


def test_sharded_accumulate_matrices(data, group, jax_refs):
    d = data
    single = trec.accumulate_matrices(
        t(d["wins"]), t(d["R"]), t(d["sh"]), t(d["df"]),
        t(d["subset"]).long(), t(d["weights"]), N, PIXEL)
    _same_acc(group, "mat", single, jax_refs["mat"].result())


def test_reconstruct_sharded(data, group, jax_refs, unit_ref_amplitude):
    """On the crop grid (box 16 of 32: both packages pad by 4) with IEWALD
    2 against the map."""
    d = data
    single = trec.reconstruct(d["stack"], d["poses"], d["ctf"], PIXEL,
                              subset=d["subset"], ref_volume=d["vol"],
                              device="cpu", **REC)
    jout = jax_refs["rec"].result()
    for f in ("volume", "half1", "half2"):
        got = _ranks(group, f"rec_{f}")
        for ref in (getattr(single, f).numpy(), np.asarray(getattr(jout, f))):
            scale = np.abs(ref).max()
            np.testing.assert_allclose(got, ref, rtol=2e-4,
                                       atol=2e-4 * scale)


def test_sharded_reconstruct(data, group, jax_refs):
    d = data
    single = trec.accumulate(
        t(d["stack16"]), t(d["poses16"]), t(d["ctf16"]),
        torch.arange(16) % 2, torch.ones(16), N, PIXEL)
    _same_acc(group, "sr", single, jax_refs["sr"].result())


def test_csp_refine_batch_sharded(data, group, jax_refs):
    """3 series over 2 ranks: the second rank's block ends in a zero-
    validity copy, which is cut."""
    d = data
    offs, spin = jcsp.build_mode_offsets(CSP_MODES, CSP_GRID, 3)
    kw = dict(iters_per_mode=CSP_ITERS)
    args = (tcsp.CspParams(*(t(d[f"csp_p{i}"]) for i in range(6))),
            t(d["csp_xv"]), t(d["csp_wc"]), t(d["csp_df"]), t(d["csp_mask"]),
            tfs.volume_to_fourier(t(d["csp_vol"])), t(d["csp_tw"]),
            t(d["csp_va"]), offs, spin, CSP_MODES, NBOX, PIXEL)
    single = tcsp.csp_refine_batch(*args, **kw)
    jout = jax_refs["csp"].result()
    for i in range(6):
        got = _ranks(group, f"csp_p{i}")
        np.testing.assert_allclose(got, single[0][i].numpy(), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(got, np.asarray(jout[0][i]), rtol=0,
                                   atol=1e-3)
    for key, k in (("csp_ms", 1), ("csp_ps", 2)):
        got = _ranks(group, key)
        np.testing.assert_allclose(got, single[k].numpy(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(got, np.asarray(jout[k]), rtol=0,
                                   atol=1e-5)


def test_sharded_refine_step_model_axis(data, group, jax_refs):
    """Mask points split over a model axis of 2: the autograd all_reduce
    gives each rank the full score and gradient."""
    d = data
    pts = tr3.make_mask_points(N, PIXEL, 40.0, 2.5 * PIXEL)
    poses_r, scores_r = tr3.local_refine(
        t(d["step_stack"]), t(d["step_ctf"]), tfs.volume_to_fourier(t(d["vol"])),
        t(d["step_init"]), t(pts), N, PIXEL, iters=6)
    jp, js = jax_refs["step"].result()
    poses, scores = (_ranks(group, k) for k in ("step_poses", "step_scores"))
    for ref_p, ref_s in ((poses_r.numpy(), scores_r.numpy()),
                         (np.asarray(jp), np.asarray(js))):
        np.testing.assert_allclose(scores, ref_s, rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(poses, ref_p, rtol=1e-3, atol=5e-2)


def test_process_range_and_unequal_chunks(data, group):
    assert multihost.process_range(15, 2, 0) == (0, 8)
    assert multihost.process_range(15, 2, 1) == (8, 15)
    assert multihost.process_range(3, 4, 3) == (3, 3)
    assert [tuple(o["range"]) for o in group.get()] == [(0, 8), (8, 15)]
    # chunks of 10 and 5 rows in batches of 4: three rounds on rank 0, two
    # on rank 1, which all_reduces a third, empty, round
    single = trec.reconstruct(data["stack"], data["poses"], data["ctf"],
                              PIXEL, subset=data["subset"], device="cpu")
    ref = single.volume.numpy()
    np.testing.assert_allclose(_ranks(group, "dist_volume"), ref, rtol=2e-4,
                               atol=2e-4 * np.abs(ref).max())


def test_two_rank_refine_writes_what_one_rank_writes(group, monkeypatch):
    """`refine` on the 2-rank group (rows split, rank 0 writes) against the
    same call on one process: the same files, poses and maps within the
    refine parity tolerances; rank 1's copy of the project is untouched."""
    tmp = group.tmp
    monkeypatch.chdir(tmp / "single")
    monkeypatch.delenv("PYP_TPU_COORDINATOR", raising=False)
    assert tcli.main(REFINE_ARGV, device="cpu") == 0
    assert [int(o["refine_rc"]) for o in group.get()] == [0, 0]
    two, one = tmp / "projects" / "rank0" / "maps", tmp / "single" / "maps"
    assert sorted(p.name for p in two.iterdir()) == sorted(
        p.name for p in one.iterdir())
    assert sorted(p.name for p in (tmp / "projects" / "rank1").rglob("*")
                  ) == group.before
    for it in (2, 3):
        a = jcistem.read_parameters(two / f"dataset_r01_{it:02d}.cistem")
        b = jcistem.read_parameters(one / f"dataset_r01_{it:02d}.cistem")
        pa = np.stack([np.asarray(a[k]) for k in ("phi", "theta", "psi")], 1)
        pb = np.stack([np.asarray(b[k]) for k in ("phi", "theta", "psi")], 1)
        assert np.mean(rot_diff_deg(pa, pb) < 1.0) >= 0.9
        assert np.median(np.abs(np.asarray(a["x_shift"])
                                - np.asarray(b["x_shift"]))) < 0.05 * PIXEL
        ma = jmrc.read(two / f"dataset_r01_{it:02d}.mrc").ravel()
        mb = jmrc.read(one / f"dataset_r01_{it:02d}.mrc").ravel()
        assert np.corrcoef(ma, mb)[0, 1] >= 0.99
    ha = json.loads((two / "dataset_r01_history.json").read_text())
    hb = json.loads((one / "dataset_r01_history.json").read_text())
    for x, y in zip(ha, hb):
        assert abs(1 / x["resolution"] - 1 / y["resolution"]) <= 1.0 / (
            N * PIXEL)
