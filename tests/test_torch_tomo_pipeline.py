"""The tomography slice as a whole on the CPU: a small synthetic tilt
series of `tools/e2e_tomo` (13 tilts of 384² at 4 Å/px, a CTF, planted
shifts and a 3° tilt axis) through `process_tilt_series` of both
packages, the bundles, tomograms and picks compared; each package
resuming from the other's bundle; the .mdoc movie path; `cli.main(["tomo",
...], device="cpu")`; every refusal by name; and one series that holds
the port alone to its planted truth.

Where the packages agree by design, the prealignment path
(-tomo_ali_patches 0, axis 0) is compared: tilt angles equal, shifts
within 2e-3 unbinned px, the CTF fits' defocus within 0.2 x ctf_fstep and
the other columns within 1e-3 relative, tomograms rtol 1e-3 with atol
1e-3 x max|reference| (the port sums a WBP block's tilts in another order
than JAX's scan), picks as sets of (z, y, x). The port departs from the
JAX package where the latter is wrong, and the tests hold it to that:
on the patch and bead paths, where "xf" holds minus the model's aligning
shifts in both packages, the port records that sign in the bundle and
backprojects the aligning shifts with the tilts turned by the fitted
axis (JAX backprojects "xf" as it is and ignores the axis); patches are
followed from tilt to tilt (`ops.tomo.TILT_TO_TILT`); and the WBP returns
exactly `thickness` slices. Each option of the pipeline is compared
with the JAX package in test_torch_tomo_options.py, the patch and bead
paths and their bundles crossing over in test_torch_tomo_paths.py.
"""

import contextlib
import io
import json
import shutil

import numpy as np
import pytest
import torch

from pyp_tpu import cli as jcli
from pyp_tpu.io.metadata import ItemMetadata as JMeta
from pyp_tpu.pipeline import tomo as jtomo
from pyp_tpu_torch import cli as tcli
from pyp_tpu_torch.config import schema
from pyp_tpu_torch.io import mrc
from pyp_tpu_torch.io.metadata import ItemMetadata as TMeta
from pyp_tpu_torch.ops import tomo as ttomo_ops
from pyp_tpu_torch.pipeline import tomo as ttomo
from pyp_tpu_torch.tools import e2e_tomo

SMALL = dict(size=384, pixel=4.0, tilt_step=10.0, shift_px=4.0,
             n_particles=12, n_beads=8, seed=3)
BASE = dict(scope_pixel=4.0, ctf_tile=128, ctf_min_def=20000.0,
            ctf_max_def=50000.0, tomo_rec_thickness=288,
            tomo_rec_binning=8, tomo_ali_patch_size=32,
            tomo_spk_method="auto", tomo_spk_rad=64.0,
            plot_per_item=False)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def params_with(**kw):
    p = schema.defaults()
    p.update(BASE)
    p.update(kw)
    return p


def close(port, ref, rtol=1e-3, atol_rel=1e-3):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    atol = atol_rel * max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def series(tmp_path_factory):
    d = tmp_path_factory.mktemp("series")
    truth, _ = e2e_tomo.write_series(d, device="cpu", **SMALL)
    tilts = mrc.read(d / "ts01.mrc").astype(np.float32)
    return d, truth, tilts


def _run(pkg, series, work, **kw):
    d, truth, tilts = series
    item = {"name": "ts01", "tilts": tilts.copy(),
            "angles": np.asarray(truth["angles"], np.float32)}
    p = params_with(**kw)
    if pkg == "jax":
        return jtomo.process_tilt_series(item, p, work)
    return ttomo.process_tilt_series(item, p, work, device="cpu")


@pytest.fixture(scope="module")
def prealigned(series, tmp_path_factory):
    """Both packages on the prealignment path (no patches, axis 0)."""
    out = {}
    for pkg in ("jax", "port"):
        work = tmp_path_factory.mktemp(f"pre_{pkg}")
        out[pkg] = (work, _run(pkg, series, work, tomo_ali_patches=0))
    return out


def assert_ctf_agree(a, b, fstep=250.0):
    np.testing.assert_allclose(a[:, :2], b[:, :2], atol=0.2 * fstep)
    np.testing.assert_allclose(a[:, 3:], b[:, 3:], rtol=1e-3, atol=1e-3)


def test_prealigned_bundles_tomograms_and_picks_agree(prealigned):
    (jw, js), (tw, ts) = prealigned["jax"], prealigned["port"]
    j, t = JMeta("ts01", jw, mode="tomo").load(), TMeta("ts01", tw, mode="tomo").load()
    assert set(j.arrays) == t.entries() == {"tlt", "xf", "ctf", "rec_done", "box"}
    np.testing.assert_array_equal(t["tlt"], j["tlt"])
    assert t["xf"].dtype == j["xf"].dtype
    np.testing.assert_allclose(t["xf"], j["xf"], atol=2e-3)
    assert t["ctf"].dtype == j["ctf"].dtype == np.float32
    assert_ctf_agree(t["ctf"], j["ctf"])
    jr, tr = mrc.read(jw / "ts01.rec.mrc"), mrc.read(tw / "ts01.rec.mrc")
    assert tr.shape == jr.shape == (48, 64, 64)
    close(tr, jr)
    assert {tuple(r[:3]) for r in t["box"]} == {tuple(r[:3]) for r in j["box"]}
    np.testing.assert_allclose(np.sort(t["box"][:, 3]), np.sort(j["box"][:, 3]),
                               rtol=1e-3, atol=1e-3)
    # the port adds the sign of the shifts in "xf"
    assert t.scalars == dict(j.scalars, xf_shift_sign=1.0)
    assert ts["particles"] == js["particles"] == len(t["box"])
    assert ts["mean_defocus"] == pytest.approx(js["mean_defocus"], abs=50.0)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_resumes_the_others_bundle(writer, prealigned, series,
                                                tmp_path):
    """The other package skips alignment, CTF and reconstruction, and picks
    on the tomogram it finds."""
    src = prealigned[writer][0]
    work = tmp_path / "resume"
    shutil.copytree(src, work)
    path = work / "ts01.meta.npz"
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files if k != "box"}
    np.savez_compressed(path, **arrays)
    before = mrc.read(work / "ts01.rec.mrc")
    reader = "port" if writer == "jax" else "jax"
    d, truth, tilts = series
    summary = _run(reader, series, work, tomo_ali_patches=0)
    assert "align_residual_px" not in summary
    np.testing.assert_array_equal(mrc.read(work / "ts01.rec.mrc"), before)
    back = TMeta("ts01", work, mode="tomo").load()
    for k in ("xf", "ctf", "tlt"):
        np.testing.assert_array_equal(back[k], arrays[k])
    picks = {tuple(r[:3]) for r in back["box"]}
    orig = TMeta("ts01", src, mode="tomo").load()["box"]
    assert picks == {tuple(r[:3]) for r in orig}


def test_a_resumed_port_series_reads_no_tilts(prealigned, series, tmp_path,
                                              monkeypatch):
    """With alignment, CTF and tomogram in the bundle, the stack is not
    read (only its header); the summary still counts the picks."""
    work = tmp_path / "again"
    shutil.copytree(prealigned["port"][0], work)
    read = []
    real = mrc.read
    monkeypatch.setattr(ttomo.mrc, "read",
                        lambda p, *a, **k: read.append(str(p)) or real(p))
    s = ttomo.process_tilt_series(
        {"name": "ts01", "path": str(series[0] / "ts01.mrc"),
         "angles": TMeta("ts01", work, mode="tomo").load()["tlt"]},
        params_with(tomo_ali_patches=0), work, device="cpu")
    assert read == [] and s["particles"] > 0


@pytest.fixture(scope="module")
def patched(series, tmp_path_factory):
    """The port on the default patch-tracking path."""
    work = tmp_path_factory.mktemp("patch_port")
    return {"port": (work, _run("port", series, work))}


def test_patch_path_stores_aligning_shifts_and_turns_the_tilts(patched, series):
    """The port's bundle is its own ops chain: prealign, tilt-to-tilt
    patch tracks, the robust solve, and minus the model's aligning shifts
    in "xf" (as the JAX package stores them) with that sign in the
    bundle's scalars; its tomogram is the WBP of the tilts turned by the
    axis and moved by the aligning shifts (ROADMAP Queue 3)."""
    _, truth, tilts = series
    tw, _ = patched["port"]
    t = TMeta("ts01", tw, mode="tomo").load()
    from pyp_tpu_torch.core.fft import bin_images

    angles = np.asarray(truth["angles"], np.float32)
    tb = bin_images(torch.from_numpy(tilts), 3)
    sh = ttomo_ops.prealign_tilt_series(tb, angles, device="cpu")
    n = tb.shape[-1]
    g = np.linspace(n * 0.25, n * 0.75, 3)
    centers = np.array([(y, x) for y in g for x in g], np.float32)
    tracks = ttomo_ops.track_patches(tb, sh, angles, centers, patch_size=32,
                                     device="cpu")
    model, _ = ttomo_ops.solve_projection_model_robust(tracks, angles, (n, n))
    np.testing.assert_allclose(t["xf"][:, :2], -model.shifts * 3, atol=1e-4)
    assert t.scalars[ttomo.XF_SIGN] == -1.0
    assert t["xf"][0, 2] == pytest.approx(float(model.axis_angle))
    # the port's tomogram is the WBP of the turned, shifted tilts
    t2 = bin_images(tb, 2)
    want = ttomo_ops.wbp_reconstruct(
        ttomo_ops.align_tilts(t2, -t["xf"][:, :2] / 6, t["xf"][0, 2],
                              device="cpu"),
        angles, thickness=48, device="cpu").numpy()
    close(mrc.read(tw / "ts01.rec.mrc"), want, rtol=1e-5, atol_rel=1e-5)


def test_planted_series_is_recovered_by_the_port_alone(patched, series):
    """The port against the planted truth at this small size (13 tilts
    10° apart, 384² at 4 Å/px, binned 3 to 12 Å/px for alignment): axis
    within 1°, median shift error under 2 binned px, mean defocus within
    2%, tomogram cc above 0.3 in the central slab of a 24 Å grid. The
    full-size bars (`chip_smoke.py`: 0.5°, 1 binned px, cc 0.6, pick
    recall) hold on the card, where the tilts are 3° apart and a particle
    spans 12 voxels."""
    _, truth, _ = series
    tw, summary = patched["port"]
    t = TMeta("ts01", tw, mode="tomo").load()
    assert e2e_tomo.axis_error_deg(t["xf"], truth) <= 1.0
    assert np.median(e2e_tomo.shift_errors_px(
        t["xf"], truth, 3, t.scalars[ttomo.XF_SIGN])) < 2.0
    assert e2e_tomo.defocus_rel_error(t["ctf"], truth) < 0.02
    rec = torch.from_numpy(mrc.read(tw / "ts01.rec.mrc").astype(np.float32))
    tt = e2e_tomo.truth_tomogram(truth, tuple(rec.shape), 24.0, device="cpu")
    off = e2e_tomo.best_offset(rec, tt, 3)
    assert e2e_tomo.slab_cc(rec, tt, off, half=6) > 0.3


def test_mdoc_series_assembles_as_in_jax(tmp_path):
    d = tmp_path / "movies"
    kw = dict(SMALL, size=256, pixel=8.0, tilt_step=20.0)
    e2e_tomo.write_series(d, movies=True, device="cpu", **kw)
    mdoc = d / "ts01.mrc.mdoc"
    p = params_with(scope_pixel=8.0, movie_search=8.0)
    ref = jtomo.assemble_tilt_series(mdoc, p)
    port = ttomo.assemble_tilt_series(mdoc, p, device="cpu")
    assert port["name"] == ref["name"] == "ts01"
    for k in ("angles", "doses", "order"):
        np.testing.assert_array_equal(port[k], ref[k])
    close(port["tilts"].numpy(), ref["tilts"], rtol=1e-4, atol_rel=1e-4)
    assert port["angles"].tolist() == sorted(port["angles"].tolist())


def _cli(main, argv, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv, **kw)
    text = buf.getvalue()
    return rc, json.loads(text[text.index("{"):]) if "{" in text else None


@pytest.mark.parametrize("sidecar", [".rawtlt", None])
def test_cli_tomo_mode(sidecar, tmp_path, monkeypatch):
    rng = np.random.RandomState(4)
    stack = rng.randn(5, 64, 64).astype(np.float32)
    data = tmp_path / "data"
    data.mkdir()
    mrc.write(stack, data / "ts9.mrc", pixel_size=4.0)
    if sidecar:
        np.savetxt(data / f"ts9{sidecar}", [-40.0, -20.0, 0.0, 20.0, 40.0])
    argv = ["tomo", "-data_path", str(data / "*.mrc"), "-scope_pixel", "4.0",
            "-ctf_tile", "32", "-tomo_rec_thickness", "128",
            "-no_plot_per_item"]
    out = {}
    runs = [("port", tcli.main, {"device": "cpu"})]
    if sidecar:
        runs.append(("jax", jcli.main, {}))
    for tag, main, kw in runs:
        work = tmp_path / tag
        work.mkdir()
        monkeypatch.chdir(work)
        out[tag] = _cli(main, argv, **kw)
    assert out["port"] == (0, {"tilt_series": 1, "missing": [],
                               "particles": 0})
    t = TMeta("ts9", tmp_path / "port", mode="tomo").load()
    if sidecar:
        assert out["jax"] == out["port"]
        j = JMeta("ts9", tmp_path / "jax", mode="tomo").load()
        np.testing.assert_array_equal(t["tlt"], j["tlt"])
    want = [-40.0, -20.0, 0.0, 20.0, 40.0] if sidecar else np.linspace(-60, 60, 5)
    np.testing.assert_allclose(t["tlt"], want)
    assert (tmp_path / "port" / "ts9.rec.mrc").exists()


@pytest.mark.parametrize("flags,word", [
    (["-slurm_queue", "gpu"], "SLURM"),
])
def test_refused_tomography_options_raise_by_name(flags, word, tmp_path,
                                                  monkeypatch):
    """The SLURM parameters, refused until the SLURM slice, now write the
    tomo swarm's scripts (`word` names the route): no series is processed
    here."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("PYP_TPU_WORKER", raising=False)
    mrc.write(np.zeros((3, 64, 64), np.float32), "ts.mrc")
    assert tcli.main(["tomo", "-data_path", "ts.mrc"] + flags,
                     device="cpu") == 0
    assert word == "SLURM" and (tmp_path / "swarm" / "tomoswarm.sbatch").exists()
    assert not list(tmp_path.glob("*.meta.npz"))
    assert not list(tmp_path.glob("*.rec.mrc"))


@pytest.mark.parametrize("what", ["whiten", "cutoff", "template_auto",
                                  "template_gaussian_resize", "gaussian"])
def test_picking_helpers_match_jax(what):
    """The template-picking helpers against the JAX package's (whitening
    on a cube, the false-positive cutoff within 1e-4, template
    conditioning rtol 1e-4), and the `tomo_pick_gaussian_3d` smoothing
    against scipy.ndimage.gaussian_filter (which the JAX package calls),
    atol 1e-5 * max."""
    rng = np.random.RandomState(9)
    vol = rng.randn(16, 16, 16).astype(np.float32)
    if what == "whiten":
        close(ttomo._whiten_volume(vol, device="cpu").numpy(),
              jtomo._whiten_volume(vol), rtol=1e-4, atol_rel=1e-4)
    elif what == "cutoff":
        assert ttomo._score_cutoff_from_fp(torch.from_numpy(vol), 2.0) == \
            pytest.approx(jtomo._score_cutoff_from_fp(vol, 2.0), rel=1e-4)
    elif what == "gaussian":
        from scipy.ndimage import gaussian_filter

        close(ttomo._gaussian_filter_3d(torch.from_numpy(vol), 1.5).numpy(),
              gaussian_filter(vol, 1.5), rtol=0, atol_rel=1e-5)
    else:
        p = params_with(tomo_pick_template_invert=True,
                        tomo_pick_template_mirror=True)
        if what == "template_gaussian_resize":
            p.update(tomo_pick_mask_method="gaussian", tomo_pick_mask_sigma=1.5,
                     tomo_pick_template_size=12)
        close(ttomo._prepare_pick_template(vol, p, 8.0, device="cpu"),
              jtomo._prepare_pick_template(vol, p, 8.0), rtol=1e-4,
              atol_rel=1e-4)


OPTIONS = {
    "sart": dict(tomo_rec_method="sart", tomo_rec_sart_iters=2),
    "reconstruction_flags": dict(
        tomo_rec_erase_fiducials=True, tomo_rec_dose_weighting=True,
        tomo_rec_ctf_correct=True, tomo_hand_detect=True,
        tomo_rec_generate_halves=True, tomo_rec_filter_window="hamming"),
    "surface": dict(tomo_spk_method="surface", tomo_vir_rad=300.0,
                    tomo_vir_sh_iters=5, tomo_vir_points=40),
    "template": dict(tomo_spk_method="template", tomo_pick_ang=90.0,
                     tomo_pick_spectral_whitening=True,
                     tomo_pick_random_phase_correction=True,
                     tomo_pick_estimate_cutoff=True),
    "filament": dict(tomo_spk_method="filament"),
    "segmentation": dict(tomo_seg_open=True, tomo_spk_method="none"),
    "bm4d": dict(denoise_method="bm4d", denoise_nsearch=3),
    "nad": dict(denoise_method="nad"),
    "deconv": dict(denoise_method="deconv", denoise_lowpass=60.0),
}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_pipeline_options_run_on_the_port(option, prealigned, series,
                                          tmp_path):
    """Each option of process_tilt_series from a copy of the
    prealignment run's bundle (without its picks): the files and bundle
    entries the JAX pipeline writes for it, finite volumes. The functions
    behind them are held to JAX in test_torch_tomo.py and
    test_torch_template_match.py; the options' results to the planted
    truth at full size in chip_smoke.py."""
    work = tmp_path / option
    shutil.copytree(prealigned["port"][0], work)
    path = work / "ts01.meta.npz"
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files if k != "box"}
    np.savez_compressed(path, **arrays)
    kw = dict(OPTIONS[option], tomo_ali_patches=0)
    if option == "template":
        ref = work / "ref.mrc"
        mrc.write(e2e_tomo.particle_map(series[1], 8, 24.0, device="cpu")
                  .numpy(), ref, pixel_size=24.0)
        kw["tomo_pick_ref"] = str(ref)
    if option in ("sart", "reconstruction_flags", "bm4d", "nad", "deconv"):
        kw["tomo_rec_force"] = True
    summary = _run("port", series, work, **kw)
    back = TMeta("ts01", work, mode="tomo").load()
    rec = mrc.read(work / "ts01.rec.mrc")
    assert np.isfinite(rec).all()
    if option == "reconstruction_flags":
        assert summary["fiducials_erased"] and summary["dose_weighted"]
        assert summary["ctf_corrected"] and summary["handedness"] in (-1, 1)
        for h in ("half1", "half2"):
            assert mrc.read(work / f"ts01.rec_{h}.mrc").shape == rec.shape
    elif option in ("bm4d", "nad", "deconv"):
        den = mrc.read(work / "ts01.den.mrc")
        assert den.shape == rec.shape and np.isfinite(den).all()
    elif option == "segmentation":
        assert mrc.read(work / "ts01.seg.mrc").shape == rec.shape
        assert 0.0 < summary["membrane_fraction"] < 1.0
    elif option == "surface":
        assert back["vir"].shape[1] == 5
        if len(back["vir"]):
            assert back["spk_eulers"].shape == (len(back["box"]), 3)
    elif option == "filament":
        assert back["box"].shape[1] == 4
    if option not in ("segmentation",):
        assert back.is_done("box")
