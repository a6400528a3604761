"""The `heterogeneity` mode through `cli.main` of both packages on tiny
projects: a particle stack with its refined table (tests/test_refine3d's
particles, box 32) and, in another project, the tilt stacks `csp
-csp_save_stacks` writes (tests/test_heterogeneity's), each trained and
then evaluated with `-het_eval` on one shared het_model.npz.

The JAX trainers draw their noise with `jax.random` inside the step, so
the training runs are compared by file name, shape and finiteness (the
report's keys and counts, het_model.npz's entries and shapes); with
-het_eval on one model, the latents by value (1e-5 x max) and the
decoded volumes (1e-4 x max).
"""

import shutil

import numpy as np
import pytest

from pyp_tpu.io import cistem as jcistem
from pyp_tpu.io import mrc as jmrc
from tests.test_torch_model_modes import PKGS, run
from tests.test_torch_models import _two_threads, close

assert _two_threads   # the module fixture shared with test_torch_models


HET = ["-scope_pixel", "2.0", "-het_steps", "3", "-het_batch", "4",
       "-het_latent", "2", "-het_hidden", "16", "-het_volumes", "2",
       "-het_rhref", "5"]


@pytest.fixture(scope="module")
def het_project(tmp_path_factory):
    """stack.mrc + stack.cistem (tests/test_refine3d's particles) and, in
    another directory, stacks/ts_stack.npz (tests/test_heterogeneity's
    tilt stacks)."""
    from tests.test_heterogeneity import make_tilt_stacks
    from tests.test_refine3d import PIXEL, make_particles, make_volume

    root = tmp_path_factory.mktemp("het")
    spa, tilt = root / "spa", root / "tilt"
    spa.mkdir(), (tilt / "stacks").mkdir(parents=True)
    imgs, cp, truth = make_particles(make_volume(seed=0), n_particles=12,
                                     noise=0.1, seed=1)
    jmrc.write(np.asarray(imgs, np.float32), spa / "stack.mrc",
               pixel_size=PIXEL)
    table = jcistem.Table.zeros(12)
    table["position_in_stack"] = np.arange(1, 13)
    for k, v in (("phi", truth["phi"]), ("theta", truth["theta"]),
                 ("psi", truth["psi"]),
                 ("y_shift", -truth["shifts"][:, 0] * PIXEL),
                 ("x_shift", -truth["shifts"][:, 1] * PIXEL),
                 ("defocus_1", np.asarray(cp)[:, 0]),
                 ("defocus_2", np.asarray(cp)[:, 1])):
        table[k] = np.asarray(v, np.float64)
    jcistem.write_parameters(table, spa / "stack.cistem")
    stacks, poses, ctf = make_tilt_stacks(make_volume(seed=3), 5, T=3, seed=2)
    np.savez(tilt / "stacks" / "ts_stack.npz", stacks=stacks, poses=poses,
             ctf=ctf, weights=np.ones(stacks.shape[:2], np.float32))
    return {"spa": spa, "tilt": tilt}


@pytest.mark.parametrize("branch", ["spa", "tilt"])
def test_heterogeneity_mode_and_eval(branch, het_project, tmp_path):
    out = {}
    for pkg in PKGS:
        work = shutil.copytree(het_project[branch], tmp_path / pkg)
        rc, rep = run(pkg, ["heterogeneity"] + HET, work)
        assert rc == 0
        out[pkg] = (work, rep)
    (tw, trep), (jw, jrep) = out["port"], out["jax"]
    assert set(trep) == set(jrep)
    assert {k: trep[k] for k in ("particles", "latent_dim", "volumes")} == {
        k: jrep[k] for k in ("particles", "latent_dim", "volumes")}
    names = ["het_model.npz", "heterogeneity_latents.npz",
             "het_volume_00.mrc", "het_volume_01.mrc"]
    for name in names:
        assert (tw / name).exists() and (jw / name).exists(), name
    for name in names[2:]:
        a, b = jmrc.read(tw / name), jmrc.read(jw / name)
        assert a.shape == b.shape == (32, 32, 32) and np.isfinite(a).all()
    a, b = (np.load(w / "heterogeneity_latents.npz")["latents"]
            for w in (tw, jw))
    assert a.shape == b.shape and np.isfinite(a).all()
    ta, tb = np.load(tw / "het_model.npz"), np.load(jw / "het_model.npz")
    assert sorted(ta.files) == sorted(tb.files)
    assert all(ta[k].shape == tb[k].shape for k in ta.files if k != "_treedef")
    # -het_eval on one model (the JAX package's): the same values
    shutil.copy(jw / "het_model.npz", tw / "het_model.npz")
    for pkg, work in (("port", tw), ("jax", jw)):
        assert run(pkg, ["heterogeneity", "-het_eval"] + HET, work)[0] == 0
    a, b = (np.load(w / "heterogeneity_latents.npz")["latents"]
            for w in (tw, jw))
    close(a, b, rel=1e-5)
    for name in names[2:]:
        close(jmrc.read(tw / name), jmrc.read(jw / name), rel=1e-4)
