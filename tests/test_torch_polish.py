"""Parity of pyp_tpu_torch/ops/polish.py and the `polish` mode with the JAX
package on the CPU: per-particle frame trajectories (with and without the
spatial coupling), the dose-weighted polished average, the whole `polish`
pass on a movie, and `cli.main(["polish", ...])` in both packages on one
project. The particles are the JAX tests' own
(`tests/test_polish.make_movie_particles`: 6 particles x 6 frames, box
24 at 2 Å/px, smooth planted trajectories).

Tolerances: trajectories within 2e-3 px after 4 normalized-gradient steps
(a difference of the gradient's last bits compounds over the steps), the
score within 1e-5, polished images within 1e-4 * max|reference|, the
rewritten stack within 2e-3 * max|reference| of JAX's normalized the way
`extract` normalizes particles (the port's departure: the JAX mode
writes the raw frame average, background offset and all, into the
normalized stack).
"""

import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyp_tpu import cli as jcli
from pyp_tpu.io import cistem as jcistem
from pyp_tpu.io import mrc as jmrc
from pyp_tpu.io.metadata import ItemMetadata
from pyp_tpu.ops import fourier_slice as jfs
from pyp_tpu.ops import polish as jpol
from pyp_tpu.ops.refine3d import make_mask_points
from pyp_tpu_torch import cli as tcli
from pyp_tpu_torch.ops import fourier_slice as tfs
from pyp_tpu_torch.ops import polish as tpol
from tests.test_polish import make_movie_particles
from tests.test_refine3d import N, PIXEL

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def movie():
    return make_movie_particles()


@pytest.mark.parametrize("spatial", [0.0, 40.0], ids=["plain", "spatial"])
def test_refine_trajectories_matches(movie, spatial):
    vol, windows, poses, ctf_params, traj_true = movie
    pts = make_mask_points(N, PIXEL, 100.0, 2.5 * PIXEL)
    coords = np.random.RandomState(1).uniform(0, 100, (len(poses), 2))
    kw = dict(iters=4, reg_weight=0.5, spatial_sigma=spatial,
              coords=coords.astype(np.float32))
    tj, sj = jpol.refine_trajectories(
        jnp.asarray(windows), jnp.asarray(poses), jnp.asarray(ctf_params),
        jfs.volume_to_fourier(jnp.asarray(vol)), jnp.asarray(pts), N, PIXEL,
        **kw)
    tt, st = tpol.refine_trajectories(
        windows, poses, ctf_params, tfs.volume_to_fourier(t(vol)), pts, N,
        PIXEL, device=CPU, **kw)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0, atol=2e-3)
    assert abs(float(st) - float(sj)) < 1e-5
    # and the trajectory moves toward cancelling the planted one
    assert (np.abs(tt.numpy() + traj_true).mean()
            < np.abs(traj_true).mean())


def test_polished_average_matches(movie):
    _, windows, _, _, traj_true = movie
    doses = np.arange(1, windows.shape[1] + 1, dtype=np.float32)
    ref = jpol.polished_average(jnp.asarray(windows), jnp.asarray(-traj_true),
                                jnp.asarray(doses), PIXEL)
    got = tpol.polished_average(t(windows), t(-traj_true), t(doses), PIXEL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(ref)).max())


def planted_movie(seed=5, F=5, ny=96, nx=96, P=4):
    """A movie of frames with a few bright blobs and noise, and particle
    coordinates on them (the content matters only for parity)."""
    rng = np.random.RandomState(seed)
    frames = 0.3 * rng.randn(F, ny, nx).astype(np.float32)
    coords = rng.randint(N, ny - N, (P, 2))
    yy, xx = np.mgrid[:ny, :nx]
    for cy, cx in coords:
        frames += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 18.0)[None]
    drift = np.cumsum(rng.uniform(-0.5, 0.5, (F, 2)), 0).astype(np.float32)
    return frames, coords.astype(np.int32), drift


def test_polish_pass_matches(movie):
    vol = movie[0]
    frames, coords, drift = planted_movie()
    rng = np.random.RandomState(2)
    P = len(coords)
    poses = np.concatenate([rng.uniform(0, 180, (P, 3)),
                            np.zeros((P, 2))], 1).astype(np.float32)
    ctf = np.stack([np.full(P, 15000.0), np.full(P, 15000.0), np.zeros(P),
                    np.zeros(P)], 1).astype(np.float32)
    kw = dict(global_shifts=drift, iters=4, reg_weight=1.0)
    sj, tj = jpol.polish(frames, coords, poses, ctf, vol, PIXEL, N, **kw)
    st, tt = tpol.polish(frames, coords, poses, ctf, vol, PIXEL, N,
                         device=CPU, **kw)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0, atol=2e-3)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0,
                               atol=2e-3 * np.abs(np.asarray(sj)).max())


def test_polish_mode_matches_jax(movie, tmp_path, capsys, monkeypatch):
    """`polish` in both packages on one project: two movies with their
    bundles (picks, drift), stack.mrc + stack.cistem and a refined map."""
    vol = movie[0]
    base = tmp_path / "base"
    (base / "maps").mkdir(parents=True)
    rng = np.random.RandomState(3)
    rows = []
    for film in (1, 2):
        frames, coords, drift = planted_movie(seed=film)
        jmrc.write(frames, base / f"m{film}.mrc", pixel_size=PIXEL)
        meta = ItemMetadata(f"m{film}", base, mode="spr")
        meta["box"], meta["drift"] = coords.astype(np.float32), drift
        meta.save()
        rows += [film] * len(coords)
    B = len(rows)
    table = jcistem.Table.zeros(B)
    table["position_in_stack"] = np.arange(1, B + 1)
    table["particle_group"] = np.asarray(rows)
    for k in ("phi", "theta", "psi"):
        table[k] = rng.uniform(0, 180, B)
    table["defocus_1"] = table["defocus_2"] = np.full(B, 15000.0)
    jcistem.write_parameters(table, base / "stack.cistem")
    jmrc.write(rng.randn(B, N, N).astype(np.float32), base / "stack.mrc",
               pixel_size=PIXEL)
    jmrc.write(vol, base / "maps" / "dataset_r01_02.mrc", pixel_size=PIXEL)
    argv = ["polish", "-data_path", "m*.mrc", "-scope_pixel", str(PIXEL),
            "-extract_box", str(N), "-polish_iters", "4",
            "-no_plot_per_item"]
    stacks = {}
    for pkg, cli, kw in (("jax", jcli, {}), ("port", tcli, {"device": CPU})):
        where = tmp_path / pkg
        shutil.copytree(base, where)
        monkeypatch.chdir(where)
        assert cli.main(argv, **kw) == 0
        out = capsys.readouterr().out
        assert json.loads(out[out.rindex("{"):]) == {"polished": B}
        stacks[pkg] = jmrc.read(where / "stack.mrc")
    # the port normalizes each polished particle as `extract` does; the
    # JAX mode writes the raw dose-weighted frame average
    from pyp_tpu_torch.ops.extract import normalize_particles

    want = normalize_particles(torch.as_tensor(stacks["jax"])).numpy()
    np.testing.assert_allclose(stacks["port"], want, rtol=0,
                               atol=2e-3 * np.abs(want).max())
    # normalized: a second normalization changes nothing
    again = normalize_particles(torch.as_tensor(stacks["port"])).numpy()
    np.testing.assert_allclose(again, stacks["port"], rtol=0, atol=1e-4)
    assert np.abs(want - stacks["jax"]).max() > 0.1
