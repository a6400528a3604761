"""The ported slice end to end: pyp_tpu_torch.pipeline.refine.refine_loop
against pyp_tpu.pipeline.refine.refine_loop on the CPU (48 particles, box
32, 2 Å per pixel, refine_maxiter 2: one global and one local iteration),
with refine_engine=gather and with refine_engine=frm. The FRM runs use the
gold standard, so iteration 3 matches each half against its own half-map
bank and ends with the sub-lattice polish (the final iteration); one more
FRM loop adds per-particle defocus refinement, reference auto-masking and
both beam-tilt steps.

The JAX side runs its single-device path (PYP_TPU_DISABLE_SPMD=1), which
is the one the port mirrors. Tolerances: >= 90% of final poses within 1°
of each other; final maps Pearson cc >= 0.99; FSC(0.143) resolutions
within one Fourier shell; refined defocus within 5 Å; estimated beam tilt
within 5% of the JAX estimate (the estimator reads the iteration's map and
poses, and amplifies their last-digit differences: fed the same inputs the
two agree to 1e-3, tests/test_torch_refine3d.py). Also: both packages write the
same maps/ files, the port resumes from maps/ the JAX package wrote, the
CLI entry point runs and the loop refuses an unported engine, and
importing the port's entry points loads neither jax nor the JAX
package."""

import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_refine3d import N, PIXEL, make_particles, make_volume

from pyp_tpu.config import schema
from pyp_tpu.core.filters import lowpass_filter_3d
from pyp_tpu.core.geometry import euler_to_matrix
from pyp_tpu.io import cistem, mrc
from pyp_tpu.pipeline import refine as jref
from pyp_tpu_torch.pipeline import refine as tref

REPO = Path(__file__).resolve().parent.parent
N_PART = 48


def rot(table):
    return np.asarray(euler_to_matrix(*(jnp.asarray(np.asarray(table[k]))
                                        for k in ("phi", "theta", "psi"))))


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for this file's torch ops: several test
    workers share the machine's cores, and a thread per core in each of
    them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem():
    vol = make_volume(seed=2)
    imgs, cp, truth = make_particles(vol, n_particles=N_PART, noise=0.1, seed=5)
    cp = np.asarray(cp)
    table = cistem.Table.zeros(N_PART)
    table["position_in_stack"] = np.arange(1, N_PART + 1)
    table["pixel_size"] = np.full(N_PART, PIXEL)
    table["defocus_1"] = cp[:, 0]
    table["defocus_2"] = cp[:, 1]
    table["defocus_angle"] = cp[:, 2]
    table["occupancy"] = np.full(N_PART, 100.0)
    start = np.array(lowpass_filter_3d(jnp.asarray(vol), PIXEL, 12.0))
    params = schema.defaults()
    params.update({
        "scope_pixel": PIXEL, "refine_engine": "gather", "refine_maxiter": 2,
        "refine_rhref": "8:6", "refine_dang": "15", "refine_psi_step": 10.0,
        "refine_searchx": 3.0, "refine_shift_step": 1.5,
        "refine_rlref": 100.0, "refine_goldstandard": True,
    })
    return np.array(imgs), table, start, params


FRM = {"refine_engine": "frm", "refine_dang": "12", "refine_frm_cone": 15.0}
FRM_EXTRAS = {"refine_fdef": True, "refine_masking_method": "auto",
              "refine_beamtilt": True, "scope_beam_tilt_x": 2e-4}


def _both_loops(problem, tmp_path_factory, extra=None):
    """One JAX and one port refine_loop over the same inputs."""
    stack, table, start, params = problem
    params = {**params, **(extra or {})}
    mp = pytest.MonkeyPatch()
    mp.setenv("PYP_TPU_DISABLE_SPMD", "1")
    try:
        jdir = tmp_path_factory.mktemp("jax")
        jout = jref.refine_loop(stack, table.copy(), start, dict(params),
                                work_dir=jdir, dataset="ds")
    finally:
        mp.undo()
    tdir = tmp_path_factory.mktemp("torch")
    tout = tref.refine_loop(stack, table.copy(), start, dict(params),
                            work_dir=tdir, dataset="ds", device="cpu")
    return jdir, jout, tdir, tout


@pytest.fixture(scope="module")
def runs(problem, tmp_path_factory):
    return _both_loops(problem, tmp_path_factory)


@pytest.fixture(scope="module")
def frm_runs(problem, tmp_path_factory):
    return _both_loops(problem, tmp_path_factory, FRM)


@pytest.fixture(scope="module")
def frm_extra_runs(problem, tmp_path_factory):
    return _both_loops(problem, tmp_path_factory, {**FRM, **FRM_EXTRAS})


def _assert_same_poses(runs):
    _, (jt, _, _), _, (tt, _, _) = runs
    tr_ = np.einsum("bij,bij->b", rot(jt), rot(tt))
    diff = np.degrees(np.arccos(np.clip((tr_ - 1) / 2, -1, 1)))
    assert np.mean(diff < 1.0) >= 0.9, diff
    sh = np.abs(np.asarray(jt["x_shift"]) - np.asarray(tt["x_shift"]))
    assert np.median(sh) < 0.05 * PIXEL, sh


def _assert_same_map_and_resolution(runs):
    jdir, (_, jmap, jhist), tdir, (_, tmap, thist) = runs
    jmap = np.asarray(jmap).ravel()
    tmap = tmap.numpy().ravel()
    assert np.corrcoef(jmap, tmap)[0, 1] >= 0.99
    assert [h["iteration"] for h in thist] == [h["iteration"] for h in jhist] == [2, 3]
    for jh, th in zip(jhist, thist):
        # within one Fourier shell: |1/res_a - 1/res_b| <= 1 / (n * pixel)
        assert abs(1 / jh["resolution"] - 1 / th["resolution"]) <= 1.0 / (N * PIXEL), (jh, th)
        assert set(jh) == set(th)


def test_same_poses(runs):
    _assert_same_poses(runs)


def test_same_map_and_resolution(runs):
    _assert_same_map_and_resolution(runs)


@pytest.mark.parametrize("which", ["frm", "frm_extras"])
def test_frm_same_poses_map_and_resolution(frm_runs, frm_extra_runs, which):
    r = frm_runs if which == "frm" else frm_extra_runs
    _assert_same_poses(r)
    _assert_same_map_and_resolution(r)
    _assert_same_files(r)


def test_frm_extras_same_defocus_and_beam_tilt(frm_extra_runs):
    _, (jt, _, _), _, (tt, _, _) = frm_extra_runs
    np.testing.assert_allclose(np.asarray(tt["defocus_1"]),
                               np.asarray(jt["defocus_1"]), atol=5.0)
    d_off = np.asarray(tt["defocus_1"]) - np.asarray(tt["defocus_2"])
    np.testing.assert_allclose(d_off, np.asarray(jt["defocus_1"])
                               - np.asarray(jt["defocus_2"]), atol=1e-2)
    tx_j, tx_t = float(jt["beam_tilt_x"][0]), float(tt["beam_tilt_x"][0])
    assert tx_j != 0.0
    assert abs(tx_t - tx_j) <= 0.05 * abs(tx_j), (tx_t, tx_j)


def test_same_files(runs):
    _assert_same_files(runs)


def _assert_same_files(runs):
    jdir, _, tdir, _ = runs
    names = sorted(p.name for p in (jdir / "maps").iterdir())
    assert names == sorted(p.name for p in (tdir / "maps").iterdir())
    assert "ds_r01_03_half2.mrc" in names and "ds_r01_history.json" in names
    a = mrc.read(jdir / "maps" / "ds_r01_03.mrc")
    b = mrc.read(tdir / "maps" / "ds_r01_03.mrc")
    assert a.shape == b.shape == (N, N, N) and a.dtype == b.dtype


@pytest.mark.parametrize("engine", ["gather", "frm"])
def test_port_resumes_from_jax_maps(problem, runs, frm_runs, tmp_path, engine):
    """The port picks up after the JAX package's iteration 2 and runs only
    iteration 3, from the JAX package's map, table and half maps (with FRM
    and the gold standard, iteration 3 matches against those half maps)."""
    stack, table, start, params = problem
    if engine == "frm":
        params = {**params, **FRM}
    jdir, _, _, _ = runs if engine == "gather" else frm_runs
    (tmp_path / "maps").mkdir()
    for p in (jdir / "maps").glob("ds_r01_02*"):
        (tmp_path / "maps" / p.name).write_bytes(p.read_bytes())
    hist = json.loads((jdir / "maps" / "ds_r01_history.json").read_text())
    (tmp_path / "maps" / "ds_r01_history.json").write_text(json.dumps(hist[:1]))
    before = (tmp_path / "maps" / "ds_r01_02.mrc").read_bytes()
    _, final, history = tref.refine_loop(stack, table.copy(), start,
                                         dict(params), work_dir=tmp_path,
                                         dataset="ds", device="cpu")
    assert [h["iteration"] for h in history] == [2, 3]
    assert history[0] == hist[0]
    assert (tmp_path / "maps" / "ds_r01_02.mrc").read_bytes() == before
    assert (tmp_path / "maps" / "ds_r01_03.mrc").exists()
    assert torch.isfinite(final).all()


def test_cli_refine_and_unported(problem, tmp_path, monkeypatch):
    from pyp_tpu_torch import cli

    stack, table, start, _ = problem
    monkeypatch.chdir(tmp_path)
    # every mode of the JAX package is ported (worker, the last one, with
    # the SLURM slice): a mode outside cli.MODES exits 2; spr, tomo, sva
    # and csp, with nothing to read, exit 1
    assert "nomode" not in cli.MODES
    assert cli.main(["nomode"], device="cpu") == 2
    for mode in ("spr", "tomo", "sva", "csp"):
        assert cli.main([mode], device="cpu") == 1
    for engine in ("frm", "gather"):
        # one project directory per engine: a refine run resumes after
        # the iterations it finds in maps/
        work = tmp_path / engine
        work.mkdir()
        monkeypatch.chdir(work)
        mrc.write(stack, "stack.mrc", pixel_size=PIXEL)
        cistem.write_parameters(table, "stack.cistem")
        mrc.write(start.astype(np.float32), "initial_model.mrc", pixel_size=PIXEL)
        rc = cli.main(["refine", "-refine_engine", engine, "-refine_maxiter", "1",
                       "-refine_rhref", "8", "-refine_dang", "20",
                       "-refine_psi_step", "15", "-refine_searchx", "2",
                       "-scope_pixel", str(PIXEL), "-no_plot_per_item"],
                      device="cpu")
        assert rc == 0
        assert (work / "maps" / "dataset_r01_02.mrc").exists()
    # an engine the port does not have is refused, never switched
    with pytest.raises(NotImplementedError, match="refine_engine='hybrid'"):
        tref.refine_loop(stack, table.copy(), start,
                         {**problem[3], "refine_engine": "hybrid"},
                         work_dir=tmp_path / "hybrid", device="cpu")


def test_cli_imports_no_jax():
    """Importing the port's entry points loads neither jax nor any module
    of the JAX package."""
    code = ("import sys; import pyp_tpu_torch.cli, pyp_tpu_torch.pipeline.refine; "
            "import pyp_tpu_torch.state, pyp_tpu_torch.tools.e2e_spa; "
            "import pyp_tpu_torch.tools.profile_refine, pyp_tpu_torch.ops.frm; "
            "import pyp_tpu_torch.ops.kernels, pyp_tpu_torch.postprocess.core; "
            "import pyp_tpu_torch.postprocess.locres, pyp_tpu_torch.analysis.scores; "
            "import pyp_tpu_torch.analysis.modelfit, pyp_tpu_torch.analysis.plots; "
            "import pyp_tpu_torch.io.pdb, pyp_tpu_torch.io.star; "
            "import pyp_tpu_torch.pipeline.spr, pyp_tpu_torch.ops.motion; "
            "import pyp_tpu_torch.ops.ctf_fit, pyp_tpu_torch.ops.pick; "
            "import pyp_tpu_torch.ops.extract, pyp_tpu_torch.sched; "
            "import pyp_tpu_torch.io.metadata, pyp_tpu_torch.io.eer; "
            "import pyp_tpu_torch.io.dm, pyp_tpu_torch.tools.e2e_spr; "
            "print(sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'pyp_tpu.')) or m == 'pyp_tpu'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
