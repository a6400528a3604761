"""Parity of pyp_tpu_torch.ops.ab_initio and ops.template_match
(rotate_volume, align_volumes) with the JAX package on the CPU, at box 24
/ 2 Å per pixel with 64 particles of `tools/e2e_spa.make_dataset`, and the
`refine -refine_abinit` mode of the port's CLI.

Tolerances:
  * ab_initio_frm, soft rounds only: the poses equal (lattice
    directions, psi bins, zero shifts) and the map within 1e-3 x max|map|
    (about 1e-4 in the L2 norm): each round's map goes through
    ops/reconstruct, whose accumulators agree with JAX's to 1e-4 and
    whose FSC weighting to 1e-3 (tests/test_torch_reconstruct.py); with a
    hard round and a polish round: map cc >= 0.999 and the median pose
    difference < 0.5°;
  * classic ab_initio (two rounds on the whole stack): map cc >= 0.999,
    median pose difference < 0.5°;
  * mean_particle_score within 1e-4; ab_initio_multiseed picks the same
    seed;
  * rotate_volume within 1e-5 x max|volume|; align_volumes finds a
    rotated, hand-flipped copy (cc > 0.95, flipped) and its cc agrees
    with JAX's within 1e-3;
  * the refine -refine_abinit mode writes the initial_model.mrc that the
    function returns for the same parameters, on both engines.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pyp_tpu.ops import ab_initio as ja
from pyp_tpu.ops import template_match as jtm
from pyp_tpu_torch.core.geometry import euler_to_matrix
from pyp_tpu_torch.ops import ab_initio as ta
from pyp_tpu_torch.ops import template_match as ttm
from pyp_tpu_torch.tools import e2e_spa

BOX, PIXEL, N_PART = 24, 2.0, 64
FRM_KW = dict(n_rounds=2, start_res=24.0, end_res=12.0, angular_step=15.0,
              seed=1)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return e2e_spa.make_dataset(n_particles=N_PART, box=BOX, pixel=PIXEL,
                                noise_x=0.5, content_a=6.0, shift_max=1.0,
                                seed=3)


def cc(a, b):
    return float(np.corrcoef(np.ravel(a), np.ravel(b))[0, 1])


def pose_diff_deg(p, q):
    def R(x):
        x = torch.as_tensor(np.asarray(x, np.float32))
        return euler_to_matrix(x[:, 0], x[:, 1], x[:, 2])

    tr = torch.einsum("bij,bij->b", R(p), R(q)).numpy()
    return np.degrees(np.arccos(np.clip((tr - 1) / 2, -1, 1)))


@pytest.mark.parametrize("hard", [0, 1])
def test_ab_initio_frm_matches_jax(data, hard):
    kw = dict(FRM_KW, hard_rounds=hard, polish_rounds=hard)
    jv, jp = ja.ab_initio_frm(data["stack"], data["ctf_params"], PIXEL, **kw)
    tv, tp = ta.ab_initio_frm(data["stack"], data["ctf_params"], PIXEL,
                              device="cpu", **kw)
    jv, jp = np.asarray(jv), np.asarray(jp)
    assert tv.shape == (BOX,) * 3 and tp.shape == (N_PART, 5)
    if not hard:
        np.testing.assert_allclose(tv, jv, rtol=0,
                                   atol=1e-3 * np.abs(jv).max())
        np.testing.assert_array_equal(tp, jp)
    else:
        assert cc(tv, jv) >= 0.999
        assert np.median(pose_diff_deg(tp, jp)) < 0.5


def test_classic_ab_initio_matches_jax(data):
    kw = dict(n_rounds=2, start_res=24.0, end_res=12.0, subset_frac=1.0,
              angular_step=30.0, seed=1)
    jv, jp = ja.ab_initio(data["stack"], data["ctf_params"], PIXEL, **kw)
    tv, tp = ta.ab_initio(data["stack"], data["ctf_params"], PIXEL,
                          device="cpu", **kw)
    assert cc(tv, np.asarray(jv)) >= 0.999
    assert np.median(pose_diff_deg(tp, jp)) < 0.5


def test_mean_particle_score_and_multiseed_match_jax(data):
    stack, cp = data["stack"], data["ctf_params"]
    poses = np.stack([data["phi"], data["theta"], data["psi"],
                      -data["shifts"][:, 0], -data["shifts"][:, 1]], 1)
    js = ja.mean_particle_score(stack, cp, poses, data["volume"], PIXEL, 24.0)
    ts = ta.mean_particle_score(stack, cp, poses, data["volume"], PIXEL, 24.0,
                                device="cpu")
    assert abs(ts - js) < 1e-4 and ts > 0.3
    # the shapes of the classic test's first round: JAX compiles nothing new
    kw = dict(n_seeds=2, n_rounds=1, start_res=24.0, end_res=24.0,
              subset_frac=1.0, angular_step=30.0)
    jr = ja.ab_initio_multiseed(stack, cp, PIXEL, **kw)
    tr = ta.ab_initio_multiseed(stack, cp, PIXEL, device="cpu", **kw)
    assert tr[2] == jr[2]
    np.testing.assert_allclose(tr[3], jr[3], atol=1e-4)


def test_rotate_volume_matches_jax_and_align_volumes_finds_a_flipped_copy(data):
    vol = data["volume"]
    for angles in ((33.0, 71.0, -100.0), (0.0, 0.0, 0.0), (181.5, 12.0, 45.0)):
        ref = np.asarray(jtm.rotate_volume(jnp.asarray(vol), *angles))
        out = ttm.rotate_volume(torch.from_numpy(vol), *angles).numpy()
        np.testing.assert_allclose(out, ref, rtol=0,
                                   atol=1e-5 * np.abs(vol).max())
    moved = np.ascontiguousarray(np.asarray(
        jtm.rotate_volume(jnp.asarray(vol), 40.0, 60.0, 200.0))[::-1])
    jc = jtm.align_volumes(moved, vol, coarse_step=45.0, iters=30)
    tc = ttm.align_volumes(moved, vol, coarse_step=45.0, iters=30, device="cpu")
    assert tc[2] and jc[2]
    assert tc[0] > 0.95, tc[:3]
    assert abs(tc[0] - jc[0]) < 1e-3
    assert tc[3].shape == vol.shape


@pytest.mark.parametrize("engine", ["frm", "classic"])
def test_refine_abinit_mode_writes_the_functions_map(data, engine, tmp_path,
                                                     monkeypatch):
    from pyp_tpu_torch import cli
    from pyp_tpu_torch.io import mrc

    e2e_spa.write_project(tmp_path, data, np.zeros((BOX,) * 3, np.float32),
                          pixel=PIXEL)
    (tmp_path / "initial_model.mrc").unlink()
    monkeypatch.chdir(tmp_path)
    argv = ["refine", "-refine_abinit", "-abinit_engine", engine,
            "-abinit_rounds", "2", "-abinit_start_res", "24",
            "-abinit_end_res", "12", "-abinit_angular_step", "30",
            "-abinit_hard_rounds", "1", "-abinit_polish_rounds", "1",
            "-abinit_seed", "1", "-abinit_subset_frac", "1",
            "-refine_maxiter", "1", "-refine_rhref", "10", "-refine_dang", "30",
            "-refine_rlref", "40", "-scope_pixel", str(PIXEL),
            "-no_plot_per_item"]
    assert cli.main(argv, device="cpu") == 0
    written = mrc.read("initial_model.mrc")
    common = dict(n_rounds=2, start_res=24.0, end_res=12.0,
                  angular_step=30.0, seed=1, device="cpu")
    if engine == "frm":
        vol, _ = ta.ab_initio_frm(data["stack"], data["ctf_params"], PIXEL,
                                  hard_rounds=1, polish_rounds=1, **common)
    else:
        vol, _ = ta.ab_initio(data["stack"], data["ctf_params"], PIXEL,
                              subset_frac=1.0, **common)
    np.testing.assert_allclose(written, vol, rtol=0,
                               atol=1e-5 * np.abs(vol).max())
    assert (tmp_path / "maps" / "dataset_r01_02.mrc").exists()
