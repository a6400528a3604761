"""The model modes and options of the SPA side through `cli.main` of both
packages on tiny projects: `sprtrain` (with -train_bin), `spr
-detect_method nn` with either package's picker_model.npz, `spr
-denoise_spr n2n -prism_enable` and `prism`. The tomography side is in
test_torch_model_modes_tomo.py, `heterogeneity` in
test_torch_heterogeneity_mode.py.

Both packages start from the same weights (flax's init carried into the
port, `test_torch_models.carried_init`) and draw the same batches, so
the files are compared by value: weights (kernels 1e-4 x max, a bias in
front of a GroupNorm only through the outputs), picks equal as sets with
scores within 1e-4, the denoised average 1e-4 x max, prism scores 1e-3
x max.
"""

import contextlib
import io
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyp_tpu import cli as jcli
from pyp_tpu.io import mrc as jmrc
from pyp_tpu.io.metadata import ItemMetadata as JMeta
from pyp_tpu.models.quality import QualityAE as JQualityAE
from pyp_tpu.pipeline import spr as jspr
from pyp_tpu_torch import cli as tcli
from pyp_tpu_torch.io.metadata import ItemMetadata as TMeta
from pyp_tpu_torch.models import io as tio
from pyp_tpu_torch.models.unet import UNet2D
from pyp_tpu_torch.pipeline import spr as tspr
from tests.test_models import make_labeled_micrographs
from tests.test_torch_models import (_two_threads, carried_init, close,
                                     np_tree, unet_init)

assert _two_threads   # the module fixture shared with test_torch_models
PKGS = {"jax": jcli, "port": tcli}
SPR = ["-scope_pixel", "1.0", "-detect_rad", "4", "-extract_box", "16",
       "-no_plot_per_item"]


def run(pkg, argv, cwd):
    """cli.main of one package in `cwd`; (rc, the last JSON object it
    printed)."""
    buf = io.StringIO()
    here = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(buf):
            kw = {"device": "cpu"} if pkg == "port" else {}
            rc = PKGS[pkg].main(argv, **kw)
    finally:
        os.chdir(here)
    text = buf.getvalue()
    return rc, (json.loads(text[text.rindex("\n{"):]) if "\n{" in text
                else json.loads(text[text.index("{"):]) if "{" in text
                else None)


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    """Two micrographs of dark particles: 6-frame movies (movies/) and
    bundles holding drift, average, CTF and the planted picks."""
    root = tmp_path_factory.mktemp("spr_models")
    mics, coords = make_labeled_micrographs(n_mics=2, n=128, n_particles=6,
                                            radius=4)
    rng = np.random.RandomState(11)
    (root / "movies").mkdir()
    for i, (m, c) in enumerate(zip(mics, coords)):
        frames = (m[None] + 0.8 * rng.randn(6, *m.shape)).astype(np.float32)
        jmrc.write(frames, root / "movies" / f"m{i}.mrc")
        meta = JMeta(f"m{i}", root, mode="spr")
        meta["drift"] = np.zeros((6, 2), np.float32)
        meta["average"] = frames.mean(axis=0)
        meta["ctf"] = np.array([15000.0, 15000.0, 0.0, 0.0, 0.5, 6.0])
        meta["box"] = np.concatenate([c, np.ones((len(c), 1))], axis=1)
        meta.save()
    return root


def fork(src, dst, drop=("box",)):
    """A copy of the project whose bundles lack `drop`."""
    shutil.copytree(src, dst)
    for path in dst.glob("*.meta.npz"):
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files if k not in drop}
        np.savez_compressed(path, **arrays)
    return dst


def picks(meta):
    box = np.asarray(meta["box"])
    return {tuple(r[:2]) for r in box}, np.sort(box[:, 2])


def assert_picks_agree(t, j):
    (ts, tv), (js, jv) = picks(t), picks(j)
    assert ts == js
    np.testing.assert_allclose(tv, jv, rtol=1e-4, atol=1e-4)


def assert_unet_files_agree(tpath, jpath, features, rel=1e-4):
    like = UNet2D(features).state_dict()
    (t, tm), (j, jm) = (tio.load_params(p, like) for p in (tpath, jpath))
    assert {k: v.tolist() for k, v in tm.items()} == {
        k: v.tolist() for k, v in jm.items()}
    for k in j:
        if k.endswith("kernel"):
            close(t[k], j[k].numpy(), rel=rel)
    x = torch.as_tensor(np.random.RandomState(1).randn(2, 1, 32, 32),
                        dtype=torch.float32)
    outs = []
    for sd in (t, j):
        net = UNet2D(features)
        net.load_state_dict(sd)
        outs.append(net.eval()(x).detach().numpy())
    close(outs[0], outs[1], rel=rel)


@pytest.fixture(scope="module")
def sprtrain(project, tmp_path_factory):
    """`sprtrain` in each package (Fourier-binned by 2) on the picks."""
    root = tmp_path_factory.mktemp("sprtrain")
    argv = ["sprtrain"] + SPR + ["-train_bin", "2", "-train_patch", "32",
                                 "-train_steps", "3", "-train_batch", "4"]
    out = {}
    for pkg in PKGS:
        work = shutil.copytree(project, root / pkg)
        with carried_init(UNet2D=unet_init((8, 16, 32))):
            rc, rep = run(pkg, argv, work)
        assert rc == 0 and rep["micrographs"] == 2 and rep["particles"] == 12
        out[pkg] = work / "picker_model.npz"
    return out


def test_sprtrain_matches(sprtrain):
    assert_unet_files_agree(sprtrain["port"], sprtrain["jax"], (8, 16, 32))


@pytest.mark.parametrize("model_from", ["jax", "port"])
def test_detect_method_nn_with_either_packages_model(model_from, sprtrain,
                                                     project, tmp_path):
    """A picker one package trained picks the same in both."""
    out = {}
    for pkg in PKGS:
        work = fork(project, tmp_path / pkg)
        shutil.copy(sprtrain[model_from], work / "picker_model.npz")
        argv = ["spr", "-data_path", str(work / "movies" / "m*.mrc"),
                "-detect_method", "nn", "-detect_nn_threshold", "0.05"] + SPR
        rc, rep = run(pkg, argv, work)
        assert rc == 0
        out[pkg] = work
    for i in range(2):
        t = TMeta(f"m{i}", out["port"]).load()
        j = JMeta(f"m{i}", out["jax"]).load()
        assert len(j["box"]) > 0
        assert_picks_agree(t, j)


def test_denoise_spr_n2n_with_prism_enable(project, tmp_path):
    """The micrograph denoiser (trained on the first micrograph's even/odd
    frames, reused for the rest), the auto picks on the denoised average,
    and the prism scores `-prism_enable` writes after the merge."""
    out = {}
    argv = ["-denoise_spr", "n2n", "-denoise_epochs", "3", "-denoise_patch",
            "32", "-denoise_batch", "4", "-detect_thresh", "0.5",
            "-prism_enable", "-prism_size", "32", "-prism_steps", "3",
            "-prism_batch", "4", "-prism_momentum", "0.9", "-prism_lr",
            "0.01"] + SPR
    qinit = jax.jit(JQualityAE(latent_dim=16).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 2)))
    for pkg in PKGS:
        work = fork(project, tmp_path / pkg)
        jspr._spr_denoiser_cache.clear()
        tspr._spr_denoiser_cache.clear()
        with carried_init(UNet2D=unet_init((16, 32)), QualityAE=qinit):
            rc, _ = run(pkg, ["spr", "-data_path",
                              str(work / "movies" / "m*.mrc")] + argv, work)
        assert rc == 0
        out[pkg] = work
    jspr._spr_denoiser_cache.clear()
    tspr._spr_denoiser_cache.clear()
    for i in range(2):
        t = TMeta(f"m{i}", out["port"]).load()
        j = JMeta(f"m{i}", out["jax"]).load()
        close(t["denoised"], j["denoised"], rel=1e-4)
        assert_picks_agree(t, j)
        np.testing.assert_allclose(t.scalars["prism_score"],
                                   j.scalars["prism_score"], atol=1e-3)
    a, b = (np.load(out[p] / "prism_embeddings.npz") for p in ("port", "jax"))
    assert list(a["names"]) == list(b["names"]) == ["m0", "m1"]
    np.testing.assert_allclose(a["scores"], b["scores"], atol=1e-3)


def test_prism_mode(project, tmp_path):
    qinit = jax.jit(JQualityAE(latent_dim=4).init)(
        jax.random.PRNGKey(2), jnp.zeros((1, 24, 24, 2)))
    argv = ["prism", "-prism_size", "24", "-prism_latent", "4",
            "-prism_steps", "3", "-prism_batch", "2", "-prism_momentum",
            "0.9", "-prism_lr", "0.01", "-prism_seed", "2"]
    reps = {}
    for pkg in PKGS:
        work = shutil.copytree(project, tmp_path / pkg)
        # a third item: a blank micrograph, unlike the other two
        meta = JMeta("blank", work, mode="spr")
        meta["average"] = (5.0 + 0.3 * np.random.RandomState(3).randn(
            128, 128)).astype(np.float32)
        meta.save()
        with carried_init(QualityAE=qinit):
            rc, reps[pkg] = run(pkg, argv, work)
        assert rc == 0
    assert reps["port"]["items"] == reps["jax"]["items"] == 3
    for name in ("blank", "m0", "m1"):
        t = TMeta(name, tmp_path / "port").load().scalars["prism_score"]
        j = JMeta(name, tmp_path / "jax").load().scalars["prism_score"]
        np.testing.assert_allclose(t, j, atol=1e-3)
    a, b = (np.load(tmp_path / p / "prism_embeddings.npz")
            for p in ("port", "jax"))
    close(a["embeddings"], b["embeddings"], rel=1e-3)


def test_training_modes_refuse_slurm_by_name(tmp_path, monkeypatch):
    """With the SLURM parameters (refused until the SLURM slice) the
    training modes write their one training job, as the JAX package's
    do, and train nothing here."""
    monkeypatch.delenv("PYP_TPU_WORKER", raising=False)
    for mode in ("sprtrain", "tomotrain"):
        rc, report = run("port", [mode, "-slurm_queue", "gpu"], tmp_path)
        assert rc == 0 and report["n_items"] == 1
        assert report["scripts"] == [f"swarm/{mode}.sbatch"]
        assert "pyp_tpu_torch.cli worker" in (
            tmp_path / "swarm" / f"{mode}.swarm").read_text()
    assert not list(tmp_path.glob("picker_model*.npz"))
