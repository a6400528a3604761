"""`tomotrain` and `mine` through `cli.main` of both packages on a small
project: a 32 x 64² tomogram of bright blobs in smooth noise
(ts01.rec.mrc) and a .spk of six picks. Both packages start from the
same weights (flax's init carried into the port) and draw the same
batches.

Tolerances: picker_model_tomo.npz's kernels and the network's outputs
1e-4 x max; mining's .spk files and gallery equal.
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyp_tpu.models.miner import Encoder3D as JEncoder3D
from pyp_tpu_torch.io import boxfiles, mrc
from tests.test_torch_model_modes import assert_unet_files_agree, run
from tests.test_torch_models import _two_threads, carried_init, unet_init

assert _two_threads   # the module fixture shared with test_torch_models


@pytest.fixture(scope="module")
def tomograms(tmp_path_factory):
    root = tmp_path_factory.mktemp("tomograms")
    rng = np.random.RandomState(4)
    vol = rng.randn(32, 64, 64)
    vol = np.fft.irfftn(np.fft.rfftn(vol) * np.exp(-40.0 * (
        np.fft.fftfreq(32)[:, None, None] ** 2
        + np.fft.fftfreq(64)[None, :, None] ** 2
        + np.fft.rfftfreq(64)[None, None, :] ** 2)), s=vol.shape)
    picks = np.stack([rng.randint(4, 28, 6), rng.randint(8, 56, 6),
                      rng.randint(8, 56, 6)], axis=1)
    zz, yy, xx = np.mgrid[:32, :64, :64]
    for z, y, x in picks:
        vol += 3 * np.exp(-((zz - z) ** 2 + (yy - y) ** 2 + (xx - x) ** 2)
                          / 8.0)
    mrc.write(vol.astype(np.float32), root / "ts01.rec.mrc", pixel_size=32.0)
    boxfiles.write_spk(picks.astype(np.float32), root / "ts01.spk")
    return root


def test_tomotrain(tomograms, tmp_path):
    argv = ["tomotrain", "-scope_pixel", "4.0", "-tomo_rec_binning", "8",
            "-tomo_spk_rad", "64", "-train_patch", "32", "-train_steps", "3",
            "-train_batch", "4"]
    reps = {}
    for pkg in ("jax", "port"):
        work = shutil.copytree(tomograms, tmp_path / pkg)
        with carried_init(UNet2D=unet_init((8, 16, 32))):
            rc, reps[pkg] = run(pkg, argv, work)
        assert rc == 0
    assert reps["port"] == reps["jax"]
    assert_unet_files_agree(tmp_path / "port" / "picker_model_tomo.npz",
                            tmp_path / "jax" / "picker_model_tomo.npz",
                            (8, 16, 32))


def test_mine(tomograms, tmp_path):
    init = jax.jit(JEncoder3D(embed_dim=6).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 8, 1)))
    argv = ["mine", "-mine_patch", "8", "-mine_steps", "3", "-mine_batch",
            "4", "-mine_clusters", "3", "-mine_embed_dim", "6"]
    for pkg in ("jax", "port"):
        work = shutil.copytree(tomograms, tmp_path / pkg)
        with carried_init(Encoder3D=init):
            rc, rep = run(pkg, argv, work)
        assert rc == 0 and rep["tomograms"] == 1 and rep["clusters"] == 3
    gj, gt = (json.loads((tmp_path / p / "mine_gallery.json").read_text())
              for p in ("jax", "port"))
    assert gt == gj
    assert sum(c["size"] for c in gt["ts01"]) == 7 * 15 * 15   # the grid
    spk = sorted(p.name for p in (tmp_path / "jax").glob("ts01_cluster*.spk"))
    assert spk == sorted(p.name for p in (tmp_path / "port").glob(
        "ts01_cluster*.spk"))
    for name in spk:
        np.testing.assert_array_equal(
            boxfiles.read_spk(tmp_path / "port" / name),
            boxfiles.read_spk(tmp_path / "jax" / name))
