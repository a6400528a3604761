"""Score shaping (pyp_tpu_torch.analysis.scores), model fitting
(analysis.modelfit), the PDB codec copy (io.pdb) and the pseudo-atom PDB
writer of tools.e2e_spa against the JAX package on the CPU.

Tolerances: shaping keep masks, group indices and thresholds exactly equal
(the same numpy logic on the same tables; thresholds to 1e-9); structure
factors atol 1e-4 * max|F| (float32 phases up to 2 pi * 0.5 * n rad carry
~1e-5 relative error at box 48, summed over the atoms in another order);
fit cc within 1e-4, the same integer shift, per-shell FSC atol 1e-4. The
oracles of tests/test_modelfit.py keep their bars."""

import numpy as np
import pytest
import torch

from pyp_tpu.analysis import modelfit as jfit
from pyp_tpu.analysis import scores as jsc
from pyp_tpu.io import cistem as jcistem
from pyp_tpu.io import pdb as jpdb
from pyp_tpu_torch.analysis import modelfit as tfit
from pyp_tpu_torch.analysis import scores as tsc
from pyp_tpu_torch.io import cistem as tcistem
from pyp_tpu_torch.io import pdb as tpdb
from pyp_tpu_torch.tools import e2e_spa


def tables(B=300, seed=0):
    """The same particle table in each package's Table class."""
    rng = np.random.RandomState(seed)
    cols = {"phi": rng.uniform(0, 360, B), "theta": rng.uniform(0, 180, B),
            "psi": rng.uniform(0, 360, B),
            "x_shift": rng.normal(0, 2, B), "y_shift": rng.normal(0, 2, B),
            "defocus_1": rng.uniform(10000, 30000, B),
            "score": np.concatenate([rng.normal(8, 2, B // 3),
                                     rng.normal(22, 3, B - B // 3)]),
            "occupancy": np.full(B, 100.0),
            "image_is_active": np.ones(B, dtype=np.int64),
            "tilt_index": rng.randint(0, 10, B)}
    out = []
    for mod in (jcistem, tcistem):
        t = mod.Table.zeros(B)
        for k, v in cols.items():
            t[k] = v
        out.append(t)
    return out


SHAPE_CASES = {
    "fraction": dict(threshold=0.7, n_angles=5, n_defocuses=4, min_group=20),
    "auto_bimodal": dict(threshold=0.0, n_angles=3, n_defocuses=2),
    "count": dict(threshold=40.0, n_angles=4, n_defocuses=3, min_group=30),
    "windows": dict(min_defocus=14000.0, max_defocus=26000.0, min_azh=20.0,
                    max_azh=150.0, min_score=0.2, max_score=0.9,
                    first_frame=1, last_frame=7, n_angles=5, n_defocuses=5),
    "reverse_odd": dict(threshold=0.5, reverse=True, odd=True),
    "consistency": dict(threshold=0.8, consistency=True, previous=True),
}


@pytest.mark.parametrize("case", list(SHAPE_CASES))
def test_shape_scores(case):
    (tj, tt), (pj, pt) = tables(seed=1), tables(seed=2)
    kw = dict(SHAPE_CASES[case])
    prev = kw.pop("previous", None)
    out_j = jsc.shape_scores(tj, previous=pj if prev else None, **kw)
    out_t = tsc.shape_scores(tt, previous=pt if prev else None, **kw)
    np.testing.assert_array_equal(out_t[1], out_j[1])
    assert 0 < out_t[1].sum() < len(out_t[1])
    for col in ("occupancy", "image_is_active"):
        np.testing.assert_array_equal(out_t[0][col], out_j[0][col])


def test_group_thresholds_and_tomo_statistic():
    tj, _ = tables(B=240, seed=3)
    rng = np.random.RandomState(4)
    ang, dfg = jsc.assign_angular_defocus_groups(tj, 4, 3)
    ang_t, dfg_t = tsc.assign_angular_defocus_groups(tj, 4, 3)
    np.testing.assert_array_equal(ang_t, ang)
    np.testing.assert_array_equal(dfg_t, dfg)
    sc = np.asarray(tj["score"])
    pind, tilts = rng.randint(0, 60, 240), rng.uniform(-40, 40, 240)
    for kw in ({}, {"pind": pind, "tilt_angles": tilts},
               {"min_score": 0.1, "max_score": 0.95, "smooth_sigma": 0.0}):
        for threshold in (0.0, 0.6, 25.0):
            ref = jsc.group_thresholds(sc, ang, dfg, 4, 3, threshold,
                                       min_group=30, **kw)
            out = tsc.group_thresholds(sc, ang, dfg, 4, 3, threshold,
                                       min_group=30, **kw)
            for o, r in zip(out, ref):
                np.testing.assert_allclose(o, r, atol=1e-9)
    grid = rng.randn(5, 6)
    grid[1, 2] = grid[4, 0] = np.nan
    np.testing.assert_allclose(tsc._smooth_grid_nan(grid),
                               jsc._smooth_grid_nan(grid), atol=1e-12)


def test_angular_groups_consistency_and_min_projections():
    (tj, tt), (pj, pt) = tables(seed=5), tables(seed=6)
    np.testing.assert_array_equal(
        tsc.angular_groups(tt["phi"], tt["theta"], 30),
        jsc.angular_groups(tj["phi"], tj["theta"], 30))
    np.testing.assert_array_equal(tsc.consistency_keep(tt, pt, 0.85),
                                  jsc.consistency_keep(tj, pj, 0.85))
    rng = np.random.RandomState(7)
    pind, active = rng.randint(0, 40, 300), rng.rand(300) > 0.3
    np.testing.assert_array_equal(tsc.min_projections_keep(pind, active, 5),
                                  jsc.min_projections_keep(pind, active, 5))


@pytest.mark.parametrize("params", [
    {"reconstruct_mindef": 15000.0, "reconstruct_maxdef": 25000.0,
     "reconstruct_minscore": 15.0},
    {"reconstruct_score_fraction": 0.8, "reconstruct_minazh": 30.0,
     "reconstruct_maxazh": 160.0, "clean_shape_angles": 6,
     "clean_shape_defocuses": 3},
    {"reconstruct_shapr": "consistency", "reconstruct_score_fraction": 0.9},
], ids=["windows", "fraction_azh", "consistency"])
def test_shaping_mask_from_params(params):
    """tests/test_analysis.py's oracle: the reconstruct-tab spellings reach
    shape_scores and the table is not mutated; the keep mask equals the
    JAX package's."""
    (tj, tt), (pj, pt) = tables(seed=8), tables(seed=9)
    occ = np.asarray(tt["occupancy"]).copy()
    keep = tsc.shaping_mask_from_params(tt, params, previous=pt)
    np.testing.assert_array_equal(
        keep, jsc.shaping_mask_from_params(tj, params, previous=pj))
    assert (np.asarray(tt["occupancy"]) == occ).all()
    if "reconstruct_mindef" in params:
        df = np.asarray(tt["defocus_1"])
        assert ((df[keep] >= 15000) & (df[keep] <= 25000)).all()
        assert (np.asarray(tt["score"])[keep] >= 15).all()


# --- model fitting (tests/test_modelfit.py's construction) ---------------

N = 48
PIXEL = 2.0


def make_model(seed=0, n_atoms=40, spread=24.0):
    rng = np.random.RandomState(seed)
    return {"coords": rng.uniform(-spread, spread, (n_atoms, 3)).astype(np.float32),
            "weights": np.full(n_atoms, 6.0, np.float32),
            "bfactors": rng.uniform(0, 30, n_atoms).astype(np.float32),
            "elements": ["C"] * n_atoms}


def render_real_space(model, n, pixel, sigma_a=4.0):
    vol = np.zeros((n, n, n), np.float32)
    g = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"), -1)
    center = model["coords"].mean(axis=0)
    for (x, y, z), w in zip(model["coords"], model["weights"]):
        p = (np.array([z, y, x]) - center[::-1]) / pixel + n // 2
        d2 = np.sum((g - p) ** 2, axis=-1) * pixel ** 2
        vol += w * np.exp(-d2 / (2 * sigma_a ** 2))
    return vol


def matched_b(sigma_a=4.0):
    """B (Å²) whose Fourier envelope equals a sigma_a real-space Gaussian."""
    return 8 * np.pi ** 2 * (sigma_a / PIXEL) ** 2 * PIXEL ** 2


@pytest.mark.parametrize("n,center", [(48, None), (33, (1.0, -2.0, 3.5))])
def test_model_structure_factors(n, center):
    m = make_model(seed=3, n_atoms=57)
    ref = np.asarray(jfit.model_structure_factors(m, PIXEL, n, 60.0,
                                                  center_a=center))
    out = tfit.model_structure_factors(m, PIXEL, n, 60.0, center_a=center,
                                       device="cpu").numpy()
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-4 * float(np.abs(ref).max()))


@pytest.mark.parametrize("seed,shift", [(1, (0, 0, 0)), (2, (3, -2, 4))])
def test_model_map_fit(seed, shift):
    m = make_model(seed=seed)
    vol = np.roll(render_real_space(m, N, PIXEL), shift, axis=(0, 1, 2))
    noise = np.random.RandomState(seed).randn(N, N, N).astype(np.float32)
    vol = vol + 0.5 * vol.std() * noise
    ref = jfit.model_map_fit(m, vol, PIXEL, high_res=10.0,
                             extra_bfactor_a2=matched_b())
    out = tfit.model_map_fit(m, vol, PIXEL, high_res=10.0,
                             extra_bfactor_a2=matched_b(), device="cpu")
    assert out["cc"] == pytest.approx(ref["cc"], abs=1e-4)
    np.testing.assert_array_equal(out["shift_px"], ref["shift_px"])
    assert out["shift_px"].dtype == np.int32
    np.testing.assert_allclose(out["fsc"], np.asarray(ref["fsc"]), atol=1e-4)


class TestModelFitOracles:
    def test_matches_real_space_rendering(self):
        m = make_model(n_atoms=12, spread=16.0)
        m["bfactors"] = np.zeros(12, np.float32)
        F_ref = np.fft.rfftn(render_real_space(m, N, PIXEL))
        F_mod = tfit.model_structure_factors(m, PIXEL, N, matched_b(),
                                             device="cpu").numpy()
        cc = np.corrcoef(np.concatenate([F_ref.real.ravel(), F_ref.imag.ravel()]),
                         np.concatenate([F_mod.real.ravel(), F_mod.imag.ravel()]))[0, 1]
        assert cc > 0.99, cc

    def test_right_model_beats_wrong(self):
        m = make_model(seed=1)
        m["bfactors"] = np.zeros(40, np.float32)
        vol = render_real_space(m, N, PIXEL)
        fit = tfit.model_map_fit(m, vol, PIXEL, high_res=10.0,
                                 extra_bfactor_a2=matched_b(), device="cpu")
        wrong = make_model(seed=99)
        wrong["bfactors"] = np.zeros(40, np.float32)
        fit_w = tfit.model_map_fit(wrong, vol, PIXEL, high_res=10.0,
                                   extra_bfactor_a2=matched_b(), device="cpu")
        assert fit["cc"] > 0.9 and fit["cc"] > fit_w["cc"] + 0.2, (fit["cc"], fit_w["cc"])

    def test_recovers_known_translation(self):
        m = make_model(seed=2)
        m["bfactors"] = np.zeros(40, np.float32)
        shift = (3, -2, 4)
        vol = np.roll(render_real_space(m, N, PIXEL), shift, axis=(0, 1, 2))
        fit = tfit.model_map_fit(m, vol, PIXEL, high_res=10.0,
                                 extra_bfactor_a2=matched_b(), device="cpu")
        assert tuple(fit["shift_px"]) == shift and fit["cc"] > 0.9
        assert np.median(fit["fsc"][2:8]) > 0.8


@pytest.mark.parametrize("writer,reader", [(tpdb, jpdb), (jpdb, tpdb)],
                         ids=["port_writes", "jax_writes"])
def test_pdb_files_cross_read(writer, reader, tmp_path):
    m = make_model(seed=4, n_atoms=25)
    elements = ["C", "N", "O", "S", "FE"] * 5
    paths = [tmp_path / "a.pdb", tmp_path / "b.pdb"]
    writer.write_pdb(m["coords"], paths[0], elements=elements,
                     bfactors=m["bfactors"])
    reader.write_pdb(m["coords"], paths[1], elements=elements,
                     bfactors=m["bfactors"])
    assert paths[0].read_bytes() == paths[1].read_bytes()
    a, b = reader.read_pdb(paths[0]), writer.read_pdb(paths[0])
    for k in ("coords", "weights", "bfactors"):
        np.testing.assert_array_equal(a[k], b[k])
    assert a["elements"] == b["elements"] == elements


def test_pseudo_atom_pdb_fits_its_map(tmp_path):
    """tools.e2e_spa.write_pseudo_atom_pdb: the densest voxels of a map,
    read back by both packages' readers, fit that map."""
    data = e2e_spa.make_dataset(n_particles=4, box=32, pixel=PIXEL,
                                content_a=3.0 * PIXEL, seed=2)
    vol = data["volume"]
    path = e2e_spa.write_pseudo_atom_pdb(vol, PIXEL, 32 ** 3 // 32,
                                         tmp_path / "m.pdb")
    m = tpdb.read_pdb(path)
    mj = jpdb.read_pdb(path)
    np.testing.assert_array_equal(m["coords"], mj["coords"])
    assert len(m["coords"]) == 32 ** 3 // 32
    occ = m["weights"] / 6.0
    assert occ.max() == pytest.approx(1.0) and occ.min() > 0
    fit = tfit.model_map_fit(m, vol, PIXEL, low_res=50.0, high_res=8.0,
                             device="cpu")
    assert fit["cc"] > 0.5, fit["cc"]
    assert np.abs(fit["shift_px"]).max() <= 2, fit["shift_px"]
    torch.testing.assert_close(
        torch.tensor(fit["cc"]),
        torch.tensor(jfit.model_map_fit(mj, vol, PIXEL, low_res=50.0,
                                        high_res=8.0)["cc"]),
        atol=1e-4, rtol=0)
