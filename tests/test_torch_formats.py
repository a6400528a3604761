"""The interchange formats of the port against the JAX package's: the STAR
writer, RELION particle stars (`io.relion`), RELION-4/5 tomogram,
particle and ArtiaX stars (`io.relion_tomo`), FREALIGN .par files
(`io.parfile`), Warp .tomostar files (`io.warp`) and EMAN2 HDF/LST files
(`io.eman`). Each writer writes the same bytes in both packages, each
package reads the other's files, and what is read back agrees to 1e-6
(exactly where both parse the same text). Also the three `core.geometry`
functions the formats need, against JAX to 1e-6."""

import numpy as np
import pytest
import torch

from pyp_tpu.core import geometry as jgeo
from pyp_tpu.io import cistem as jcistem
from pyp_tpu.io import eman as jeman
from pyp_tpu.io import parfile as jpar
from pyp_tpu.io import relion as jrel
from pyp_tpu.io import relion_tomo as jrt
from pyp_tpu.io import star as jstar
from pyp_tpu.io import warp as jwarp
from pyp_tpu_torch.core import geometry as tgeo
from pyp_tpu_torch.io import cistem as tcistem
from pyp_tpu_torch.io import eman as teman
from pyp_tpu_torch.io import parfile as tpar
from pyp_tpu_torch.io import relion as trel
from pyp_tpu_torch.io import relion_tomo as trt
from pyp_tpu_torch.io import star as tstar
from pyp_tpu_torch.io import warp as twarp

TOL = 1e-6


def _both_write(tmp_path, name, jwrite, twrite):
    """Write with each package; the bytes agree; returns the two paths."""
    a, b = tmp_path / f"jax_{name}", tmp_path / f"port_{name}"
    jwrite(a)
    twrite(b)
    assert a.read_bytes() == b.read_bytes(), name
    return a, b


def _assert_loops_equal(x, y):
    assert list(x) == list(y)
    for name in x:
        assert x[name]["fields"] == y[name]["fields"]
        assert list(x[name]["loop"]) == list(y[name]["loop"])
        for col in x[name]["loop"]:
            u, v = x[name]["loop"][col], y[name]["loop"][col]
            assert u.dtype == v.dtype, col
            if u.dtype == object:
                assert list(u) == list(v), col
            else:
                np.testing.assert_allclose(u, v, rtol=TOL, atol=TOL)


def _table(n=9, seed=0):
    rng = np.random.RandomState(seed)
    t = jcistem.Table.zeros(n)
    t["position_in_stack"] = np.arange(1, n + 1)
    for k in ("phi", "theta", "psi"):
        t[k] = rng.uniform(-180, 180, n)
    for k in ("x_shift", "y_shift"):
        t[k] = rng.uniform(-6, 6, n)
    t["defocus_1"] = rng.uniform(12000, 30000, n)
    t["defocus_2"] = t["defocus_1"] - rng.uniform(0, 800, n)
    t["defocus_angle"] = rng.uniform(0, 180, n)
    t["phase_shift"] = rng.uniform(0, 0.5, n)
    t["original_x_position"] = rng.uniform(0, 4096, n)
    t["original_y_position"] = rng.uniform(0, 4096, n)
    t["particle_group"] = rng.randint(1, 4, n)
    t["best_2d_class"] = rng.randint(1, 6, n)
    t["assigned_subset"] = rng.randint(1, 3, n)
    t["score"] = rng.uniform(0, 1, n)
    return t


def _port_table(t):
    return tcistem.Table(list(t.column_ids), dict(t.data))


def test_star_writer_bytes_and_cross_read(tmp_path):
    rng = np.random.RandomState(1)
    blocks = {"optics": {"fields": {"rlnVersion": "30001"}, "loop": {
        "rlnOpticsGroup": np.array([1, 2]),
        "rlnImagePixelSize": np.array([1.06, 2.12])}},
        "particles": {"fields": {}, "loop": {
            "rlnImageName": np.array([f"{i}@s.mrcs" for i in range(6)],
                                     dtype=object),
            "rlnAngleRot": rng.uniform(-180, 180, 6),
            "rlnClassNumber": np.arange(6)}},
        "root": {"fields": {"rlnNote": "x"}, "loop": {}}}
    a, b = _both_write(tmp_path, "t.star", lambda p: jstar.write(blocks, p),
                       lambda p: tstar.write(blocks, p))
    _assert_loops_equal(jstar.read(b), tstar.read(a))


def test_relion_particles_star_round_trip(tmp_path):
    """export_star / import_star (`rlnOriginX/YAngst` carry the .cistem
    shifts as they are, `rlnPhaseShift` in degrees) in both packages, and
    each package imports the other's file."""
    t = _table()
    kw = dict(pixel_size=1.3, voltage=200.0, cs=2.7, w=0.1,
              image_name_fmt="{i}@p.mrcs", optics_group=2)
    a, b = _both_write(
        tmp_path, "particles.star",
        lambda p: jrel.export_star(t, p, **kw),
        lambda p: trel.export_star(_port_table(t), p, **kw))
    for path in (a, b):
        (jt, jo), (tt, to) = jrel.import_star(path), trel.import_star(path)
        assert jo == to and to["pixel_size"] == 1.3
        assert list(jt.column_ids) == list(tt.column_ids)
        for col in jt.data:
            np.testing.assert_allclose(tt[col], jt[col], rtol=TOL, atol=TOL)
        for col in ("phi", "theta", "psi", "x_shift", "y_shift",
                    "defocus_1", "defocus_2", "defocus_angle"):
            np.testing.assert_allclose(tt[col], t[col], atol=1e-5)
        np.testing.assert_allclose(tt["phase_shift"], t["phase_shift"],
                                   atol=1e-6)
    # the star tables the two build agree block by block
    _assert_loops_equal(jrel.table_to_star(t, 1.3),
                        trel.table_to_star(_port_table(t), 1.3))


def _series(seed=3, name="TS_01", T=7):
    rng = np.random.RandomState(seed)
    rots = rng.uniform(-2, 2, T)
    xf = np.stack([np.cos(np.radians(rots)), -np.sin(np.radians(rots)),
                   np.sin(np.radians(rots)), np.cos(np.radians(rots)),
                   rng.uniform(-5, 5, T), rng.uniform(-5, 5, T)], 1)
    return {"name": name,
            "tilt_angles": np.linspace(-45, 45, T).astype(np.float32),
            "xf": xf,
            "defocus": np.stack([rng.uniform(15000, 30000, T)] * 2, 1),
            "astig_angle": rng.uniform(0, 180, T).astype(np.float32),
            "order": np.arange(T, dtype=np.float32),
            "image_dims": (512, 480)}


TOMO_PARAMS = {"scope_pixel": 2.1, "scope_voltage": 300.0, "scope_cs": 2.7,
               "scope_wgh": 0.07, "scope_dose_rate": 3.0,
               "tomo_rec_thickness": 600, "extract_box": 64,
               "extract_bin": 2}


def test_relion_tomo_stars_round_trip(tmp_path):
    """tomograms.star and the RELION-5 particle star: the same bytes, the
    same series and particles read back from either file, tilt angles
    recovered from the projection matrices to 1e-4° (the matrices'
    eight printed decimals)."""
    series = [_series(), _series(4, "TS_02", 5)]
    a, b = _both_write(
        tmp_path, "tomograms.star",
        lambda p: jrt.export_tomograms_star(series, TOMO_PARAMS, p),
        lambda p: trt.export_tomograms_star(series, TOMO_PARAMS, p))
    for path in (a, b):
        (js, jg), (ts, tg) = (jrt.import_tomograms_star(path),
                              trt.import_tomograms_star(path))
        assert jg == tg and tg["tomo_rec_thickness"] == 600
        for x, y, s in zip(js, ts, series):
            assert x.keys() == y.keys()
            assert x["name"] == y["name"] == s["name"]
            for k in ("matrices", "tilt_angles", "defocus", "astig_angle",
                      "exposure"):
                np.testing.assert_array_equal(x[k], y[k])
            np.testing.assert_allclose(y["tilt_angles"], s["tilt_angles"],
                                       atol=1e-4)
    assert jrt._parse_blocks(a.read_text()) == trt._parse_blocks(b.read_text())

    rng = np.random.RandomState(5)
    P = 11
    parts = {"tomo_names": ["TS_01"] * 6 + ["TS_02"] * 5,
             "positions": rng.uniform(0, 512, (P, 3)).astype(np.float32),
             "eulers": rng.uniform(0, 360, (P, 3)).astype(np.float32),
             "shifts": rng.uniform(-8, 8, (P, 3)).astype(np.float32),
             "visible": (rng.rand(P, 7) > 0.2).astype(np.int32)}
    a, b = _both_write(
        tmp_path, "particles.star",
        lambda p: jrt.export_particles_star_v5(parts, TOMO_PARAMS, p),
        lambda p: trt.export_particles_star_v5(parts, TOMO_PARAMS, p))
    for path in (a, b):
        x, y = (jrt.import_particles_star_v5(path),
                trt.import_particles_star_v5(path))
        assert x.keys() == y.keys() and x["optics"] == y["optics"]
        assert y["tomo_names"] == parts["tomo_names"]
        for k in ("positions", "eulers", "shifts", "visible"):
            np.testing.assert_array_equal(x[k], y[k])
            np.testing.assert_allclose(y[k], parts[k], rtol=1e-5)


def test_artiax_star_reads_the_same(tmp_path):
    rng = np.random.RandomState(6)
    args = ("ts", rng.uniform(-50, 50, (5, 3)), rng.uniform(0, 360, (5, 3)),
            (32, 64, 64), 8)
    scores = rng.rand(5)
    a, b = _both_write(
        tmp_path, "ts.star",
        lambda p: jrt.export_artiax_star(*args, p, scores=scores),
        lambda p: trt.export_artiax_star(*args, p, scores=scores))
    for path in (a, b):
        x, y = jrt.import_artiax_star(path), trt.import_artiax_star(path)
        assert list(x) == list(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize("variant,compress", [("new", False),
                                              ("frealignx", True)])
def test_parfile_round_trip(variant, compress, tmp_path):
    """.cistem -> .par (SHX/SHY the negated shifts) -> .cistem in both
    packages, plain and bz2; the text files are the same bytes."""
    t = _table(7, seed=2)
    jp, tp = (jpar.from_cistem_table(t, variant=variant),
              tpar.from_cistem_table(_port_table(t), variant=variant))
    assert jp.columns == tp.columns
    for c in jp.columns:
        np.testing.assert_array_equal(jp[c], tp[c])
    np.testing.assert_allclose(tp["SHX"], -np.asarray(t["x_shift"]))
    name = "a.par.bz2" if compress else "a.par"
    a, b = tmp_path / f"jax_{name}", tmp_path / f"port_{name}"
    jpar.write(jp, a)
    tpar.write(tp, b)
    if not compress:        # a bz2 stream is compared through its text
        assert a.read_bytes() == b.read_bytes()
    for path in (a, b):
        x, y = jpar.read(path), tpar.read(path)
        assert x.columns == y.columns
        np.testing.assert_array_equal(x.as_array(), y.as_array())
        jt, tt = jpar.to_cistem_table(x), tpar.to_cistem_table(y)
        for c in jt.data:
            np.testing.assert_array_equal(jt[c], tt[c])
        np.testing.assert_allclose(tt["x_shift"], t["x_shift"], atol=1e-2)


def test_warp_tomostar_round_trip(tmp_path):
    from pyp_tpu.io.metadata import ItemMetadata as JMeta

    rng = np.random.RandomState(7)
    meta = JMeta("ts9", tmp_path / "proj", mode="tomo")
    meta["tlt"] = np.linspace(-30, 30, 5).astype(np.float32)
    meta["xf"] = np.c_[rng.randn(5, 2), np.full(5, 85.3)].astype(np.float32)
    kw = jwarp.tomostar_from_metadata(meta)
    assert kw["movie_names"] == twarp.tomostar_from_metadata(meta)[
        "movie_names"]
    a, b = _both_write(tmp_path, "ts9.tomostar",
                       lambda p: jwarp.write_tomostar(p, **kw),
                       lambda p: twarp.write_tomostar(p, **kw))
    for path in (a, b):
        x, y = jwarp.read_tomostar(path), twarp.read_tomostar(path)
        assert x["movie_names"] == y["movie_names"]
        for k in x:
            if k != "movie_names":
                np.testing.assert_array_equal(x[k], y[k])
        np.testing.assert_allclose(y["tilt_angles"], meta["tlt"], atol=1e-5)
    out = twarp.export_tomostar_dir({"ts9": meta}, tmp_path / "warp")
    assert [p.name for p in out] == ["ts9.tomostar"]
    assert out[0].read_bytes() == a.read_bytes()


def test_eman_hdf_and_lst(tmp_path):
    """EMAN2 HDF stacks and LSX lists (h5py is present on the CPU; the card
    machine has none, where these raise ImportError by name)."""
    pytest.importorskip("h5py")
    rng = np.random.RandomState(8)
    stack = rng.randn(3, 16, 16).astype(np.float32)
    for W, name in ((jeman, "j.hdf"), (teman, "t.hdf")):
        W.write_hdf(stack, tmp_path / name, apix=1.7)
    for path in (tmp_path / "j.hdf", tmp_path / "t.hdf"):
        for R in (jeman, teman):
            back, apix = R.read_hdf(path)
            np.testing.assert_array_equal(back, stack)
            assert apix == pytest.approx(1.7)
    entries = [(i, "stack.hdf", f"c{i}" if i % 2 else "") for i in range(4)]
    _both_write(tmp_path, "l.lst",
                lambda p: jeman.write_lst(entries, p, comment="x"),
                lambda p: teman.write_lst(entries, p, comment="x"))
    assert teman.read_lst(tmp_path / "jax_l.lst") == jeman.read_lst(
        tmp_path / "port_l.lst")
    from pyp_tpu_torch.io import mrc

    mrc.write(stack, tmp_path / "s.mrc", pixel_size=1.0)
    teman.export_particles_hdf(tmp_path / "s.mrc", tmp_path / "e.hdf", 2.0)
    np.testing.assert_array_equal(jeman.read_hdf(tmp_path / "e.hdf")[0],
                                  stack)


def test_geometry_functions_against_jax():
    rng = np.random.RandomState(9)
    z1, x, z2 = (rng.uniform(-180, 180, 12).astype(np.float32)
                 for _ in range(3))
    jout = jgeo.euler_zxz_to_zyz(z1, x, z2)
    tout = tgeo.euler_zxz_to_zyz(torch.as_tensor(z1), x, z2)
    # compare the rotations (the triplet is unique but for gimbal lock)
    np.testing.assert_allclose(
        tgeo.euler_to_matrix(*tout).numpy(),
        np.asarray(jgeo.euler_to_matrix(*jout)), atol=TOL)
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-3)
    for args in ((15.0,), (10.0, 30.0, 90.0)):
        np.testing.assert_array_equal(tgeo.angular_grid(*args),
                                      jgeo.angular_grid(*args))
    for t in (0.0, -57.5, 33.0):
        xf = np.array([0.99, -0.05, 0.05, 0.99, 3.5, -2.0])
        np.testing.assert_allclose(
            tgeo.relion_tomo_projection_matrix(t, xf, 600.0, (512, 480),
                                               512, 480),
            jgeo.relion_tomo_projection_matrix(t, xf, 600.0, (512, 480),
                                               512, 480), atol=TOL)
