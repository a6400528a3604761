"""The port's particle-cleaning functions of analysis.scores and its
`clean` and `kselection` modes against the JAX package's on the CPU: each
package runs in its own copy of one seeded project (40 projections of a
seeded map at box 16 and their poses, with scores, positions, tilt
angles, classes and projection indices).

Tolerances: the functions' outputs equal (keep masks, tables; the
symmetry-expanded Euler angles within 1e-3°); after each mode the written
stack.cistem and every written file byte-identical, but the check
reconstruction and the symmetry-expanded table (Euler angles within
1e-3°, other columns equal). The check map (maps/clean_check.mrc) is
held to cc >= 0.9999 and 1e-2 x max|map|: 40 particles at box 16 leave
Fourier voxels nearly empty, where the Wiener division amplifies the
last-bit differences of the two packages' scatter sums (their half maps
differ by up to 4e-3 x max there; ops/reconstruct is held to 1e-4 at a
well-sampled size in tests/test_torch_reconstruct.py).
The class selection reads a `reference_3d` column that the .cistem format
does not have, in both packages; the test holds the port to the JAX
package there, not to the selection.
"""

import json
import shutil

import numpy as np
import pytest

from pyp_tpu import cli as jcli
from pyp_tpu.analysis import scores as jsc
from pyp_tpu.io import cistem, mrc
from pyp_tpu_torch import cli as tcli
from pyp_tpu_torch.analysis import scores as tsc
from pyp_tpu_torch.tools import e2e_spa

B, BOX, PIXEL = 40, 16, 2.0


def particles():
    """Projections of a seeded map at known poses (the check
    reconstruction needs signal to be compared)."""
    return e2e_spa.make_dataset(n_particles=B, box=BOX, pixel=PIXEL,
                                noise_x=0.3, content_a=5.0, shift_max=1.0,
                                seed=5)


def project_table(seed=0):
    rng = np.random.RandomState(seed)
    d = particles()
    t = cistem.Table.zeros(B)
    t["position_in_stack"] = np.arange(1, B + 1)
    t["image_is_active"] = np.ones(B)
    t["pixel_size"] = np.full(B, PIXEL)
    t["phi"], t["theta"], t["psi"] = d["phi"], d["theta"], d["psi"]
    t["y_shift"] = -d["shifts"][:, 0] * PIXEL
    t["x_shift"] = -d["shifts"][:, 1] * PIXEL
    t["defocus_1"], t["defocus_2"] = d["ctf_params"][:, 0], d["ctf_params"][:, 1]
    t["defocus_angle"] = d["ctf_params"][:, 2]
    t["occupancy"] = np.full(B, 100.0)
    # bimodal scores: a good and a bad population
    t["score"] = np.where(np.arange(B) % 3 == 0, rng.normal(5, 2, B),
                          rng.normal(25, 3, B))
    t["original_x_position"] = rng.uniform(0, 300, B)
    t["original_y_position"] = rng.uniform(0, 300, B)
    t["tilt_angle"] = rng.uniform(-60, 60, B)
    t["particle_index"] = np.arange(B) // 4
    t["best_2d_class"] = rng.randint(1, 4, B)
    return t


def write_project(d, seed=0):
    d.mkdir(parents=True)
    mrc.write(particles()["stack"], d / "stack.mrc", pixel_size=PIXEL)
    cistem.write_parameters(project_table(seed), d / "stack.cistem")


def test_cleaning_functions_match_jax(tmp_path):
    t = project_table()
    for kw in (dict(score_cut=12.0), dict(score_cut=None, min_occ=50.0),
               dict(score_cut=None, mode="sigma")):
        jt, jk = jsc.particle_cleaning(t.copy(), **kw)
        tt, tk = tsc.particle_cleaning(t.copy(), **kw)
        np.testing.assert_array_equal(tk, jk)
        for k in jt.data:
            np.testing.assert_array_equal(tt[k], jt[k])
    pos = np.stack([t["original_y_position"], t["original_x_position"]], 1)
    for dist in (10.0, 60.0):
        np.testing.assert_array_equal(
            tsc.remove_duplicates(pos, t["score"], dist),
            jsc.remove_duplicates(pos, t["score"], dist))
    jt, jk = jsc.select_classes(t.copy(), {1, 3})
    tt, tk = tsc.select_classes(t.copy(), {1, 3})
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tt["occupancy"], jt["occupancy"])
    for sym in ("C1", "C3", "D2"):
        je, te = jsc.expand_symmetry(t, sym), tsc.expand_symmetry(t, sym)
        assert te.n_rows == je.n_rows == B * {"C1": 1, "C3": 3, "D2": 4}[sym]
        for k in je.data:
            tol = 1e-3 if k in ("phi", "theta", "psi") else 0
            np.testing.assert_allclose(_wrap(te[k], k), _wrap(je[k], k),
                                       atol=tol)
    stack = np.random.RandomState(2).randn(B, BOX, BOX).astype(np.float32)
    jw = jsc.generate_cluster_stacks(stack, t, 3, 2, tmp_path / "j", "s")
    tw = tsc.generate_cluster_stacks(stack, t, 3, 2, tmp_path / "t", "s")
    assert [p.split("/")[-1] for p in tw] == [p.split("/")[-1] for p in jw]
    for name in [p.split("/")[-1] for p in jw] + ["s_means.mrc"]:
        assert ((tmp_path / "t" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes())


def _wrap(x, k):
    """Euler angles compared on the circle (360 and 0 are one angle)."""
    x = np.asarray(x, np.float64)
    if k in ("phi", "psi"):
        return np.mod(x + 1e-3, 360.0)
    return x


def _run(main, argv, d, monkeypatch):
    monkeypatch.chdir(d)
    assert main(argv) == 0


def _files(d):
    """Files under d, but the JAX CLI's invocation log (.pyp_history),
    which its `main` appends for every mode and the port does not keep."""
    return sorted(str(p.relative_to(d)) for p in d.rglob("*")
                  if p.is_file() and p.name != ".pyp_history")


CLEAN_CASES = {
    "otsu": ["-clean_mode", "otsu"],
    "fixed": ["-clean_mode", "fixed", "-clean_min_score", "12"],
    "percentile": ["-clean_mode", "percentile", "-clean_percentile", "30"],
    "shape": ["-clean_mode", "shape", "-clean_shape_angles", "4",
              "-clean_shape_defocuses", "3"],
    "dist": ["-clean_mode", "percentile", "-clean_dist", "40"],
    "class_selection": ["-clean_class_selection", "1,2"],
    "tilt_window": ["-clean_mintilt", "-30", "-clean_maxtilt", "30",
                    "-clean_min_num_projections", "2"],
    "discard_check": ["-clean_mode", "percentile", "-clean_discard",
                      "-clean_check_reconstruction"],
    "export": ["-clean_export_clean", "-clean_min_occ", "50"],
    "cluster_stacks": ["-clean_cluster_stacks", "-clean_shape_angles", "3",
                       "-clean_shape_defocuses", "2"],
    "check": ["-clean_check_reconstruction", "-scope_pixel", "2"],
    "files": None,
}


@pytest.mark.parametrize("case", list(CLEAN_CASES))
def test_clean_mode_matches_jax(case, tmp_path, monkeypatch, capsys):
    flags = CLEAN_CASES[case]
    outs = {}
    for name, main in (("jax", jcli.main),
                       ("port", lambda a: tcli.main(a, device="cpu"))):
        d = tmp_path / name
        write_project(d)
        if flags is None:  # the file-cleaning branch
            (d / "swarm").mkdir()
            (d / "swarm" / "job.sh").write_text("#!/bin/sh\n")
            (d / "stream_stack.mrc").write_bytes(b"x")
            (d / "mic.meta.npz").write_bytes(b"x")
            (d / "maps").mkdir()
            (d / "maps" / "m.mrc").write_bytes(b"x")
            argv = ["clean", "-clean_all"]
        else:
            argv = ["clean", "-clean_particles"] + flags
        capsys.readouterr()
        _run(main, argv, d, monkeypatch)
        printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        printed.pop("free_gb", None)
        outs[name] = (d, printed)
    (jd, jout), (td, tout) = outs["jax"], outs["port"]
    assert tout == jout
    assert _files(td) == _files(jd)
    for f in _files(jd):
        if f.endswith(".png"):
            continue
        if f == "maps/clean_check.mrc":
            a, b = mrc.read(td / f), mrc.read(jd / f)
            assert np.corrcoef(a.ravel(), b.ravel())[0, 1] >= 0.9999
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-2 * np.abs(b).max())
            continue
        assert (td / f).read_bytes() == (jd / f).read_bytes(), f


@pytest.mark.parametrize("flags", [["-keep_classes", "1,3"],
                                   ["-expand_symmetry", "D2"]],
                         ids=["keep_classes", "expand_symmetry"])
def test_kselection_mode_matches_jax(flags, tmp_path, monkeypatch):
    tables = {}
    for name, main in (("jax", jcli.main),
                       ("port", lambda a: tcli.main(a, device="cpu"))):
        d = tmp_path / name
        write_project(d)
        _run(main, ["kselection"] + flags, d, monkeypatch)
        tables[name] = cistem.read_parameters(d / "stack.cistem")
    jt, tt = tables["jax"], tables["port"]
    assert tt.column_ids == jt.column_ids and tt.n_rows == jt.n_rows
    for k in jt.data:
        tol = 1e-3 if k in ("phi", "theta", "psi") else 0
        np.testing.assert_allclose(_wrap(tt[k], k), _wrap(jt[k], k), atol=tol)
    if flags[0] == "-keep_classes":
        kept = np.isin(project_table()["best_2d_class"], [1, 3])
        np.testing.assert_array_equal(tt["image_is_active"], kept)
    else:
        assert tt.n_rows == 4 * B


def test_kselection_needs_classes(tmp_path, monkeypatch):
    write_project(tmp_path / "p")
    monkeypatch.chdir(tmp_path / "p")
    assert tcli.main(["kselection"], device="cpu") == 1
    shutil.rmtree(tmp_path / "p")
