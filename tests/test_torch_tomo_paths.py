"""The alignment paths of `process_tilt_series` in both packages on the
CPU: the patch path on test_torch_tomo_pipeline.py's small planted series
(13 tilts of 384² at 4 Å/px) and the bead path on the JAX tests' own
bead series (`tests/test_tomo.make_fiducial_series`, 25 tilts of 192²);
and the patch bundles crossing over between the packages.

"xf" holds the same values in both packages on these paths, minus the
projection model's aligning shifts, and the port records that sign in
the bundle's scalar `xf_shift_sign`. The port backprojects the aligning
shifts with the tilts turned by the fitted axis; the JAX package
backprojects "xf" as it is and ignores the axis (ROADMAP Queue 3), so the
tomograms of these paths are compared only where both packages read the
same bundle the JAX package's way: the JAX package reconstructs from the
port's patch bundle the tomogram it makes from its own, and the port
reads a JAX bundle, which has no sign, as the JAX package reads it. The
patch path runs with the JAX package's tracker
(`ops.tomo.TILT_TO_TILT = False`); the port's own is held to the planted
rotation in test_torch_tomo.py.

Tolerances: shifts within 1e-2 unbinned px and the axis angles equal
(the float64 host solves on tracks that agree within 2e-3 px); the
alignment residual within 1e-2 px; bead positions within 1e-2 px; CTF
fits are not compared here: each run starts from a bundle that holds the
planted defoci, so no fit runs (test_torch_tomo_pipeline.py compares
them); tomograms rtol 1e-3 with atol
1e-3 x max|reference| (the port sums a WBP block's tilts in another
order than JAX's scan).
"""

import shutil

import numpy as np
import pytest

from pyp_tpu.io.metadata import ItemMetadata as JMeta
from pyp_tpu.pipeline import tomo as jtomo
from pyp_tpu_torch.io import mrc
from pyp_tpu_torch.io.metadata import ItemMetadata as TMeta
from pyp_tpu_torch.ops import tomo as ttomo_ops
from pyp_tpu_torch.pipeline import tomo as ttomo
from tests.test_tomo import make_fiducial_series
from tests.test_torch_tomo_pipeline import (
    _run, _two_threads, close, params_with, series)

assert _two_threads and series   # module fixtures shared with that file

META = {"jax": JMeta, "port": TMeta}


def seed_ctf(work, defoci):
    """A bundle that holds only CTF rows (df1, df2, angle, cc, resolution)
    at the given defoci, so the CTF stage is skipped."""
    meta = TMeta("ts01", work, mode="tomo")
    df = np.asarray(defoci, np.float32)
    meta["ctf"] = np.stack([df, df] + [np.zeros_like(df)] * 3, axis=1)
    meta.save()
    return work


@pytest.fixture(scope="module")
def patched(series, tmp_path_factory):
    """Both packages on the default patch path, the port with the JAX
    package's tracker."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttomo_ops, "TILT_TO_TILT", False)
        for pkg in ("jax", "port"):
            work = seed_ctf(tmp_path_factory.mktemp(f"patch_{pkg}"),
                            series[1]["defoci"])
            out[pkg] = (work, _run(pkg, series, work))
    return out


def test_patch_path_bundle_agrees_with_jax(patched):
    (jw, js), (tw, ts) = patched["jax"], patched["port"]
    j = JMeta("ts01", jw, mode="tomo").load()
    t = TMeta("ts01", tw, mode="tomo").load()
    np.testing.assert_allclose(t["xf"][:, :2], j["xf"][:, :2], atol=1e-2)
    np.testing.assert_array_equal(t["xf"][:, 2], j["xf"][:, 2])
    assert t.scalars[ttomo.XF_SIGN] == -1.0
    assert ttomo.XF_SIGN not in j.scalars
    assert ts["align_residual_px"] == pytest.approx(js["align_residual_px"],
                                                   abs=1e-2)


def test_fiducial_path_agrees_with_jax(tmp_path):
    """The bead path: the same beads and "xf" (both minus the model's
    aligning shifts; 10 beads of 5 px radius at 4 Å/px, so 4 nm)."""
    tilts, angles, *_ = make_fiducial_series()
    p = params_with(tomo_ali_fiducial=4.0, tomo_spk_method="none",
                    tomo_rec_thickness=256)
    out = {}
    for pkg in ("jax", "port"):
        work = tmp_path / pkg
        work.mkdir()
        seed_ctf(work, np.full(len(angles), 20000.0))
        item = {"name": "ts01", "tilts": tilts.copy(),
                "angles": angles.astype(np.float32)}
        summary = (jtomo.process_tilt_series(item, p, work) if pkg == "jax"
                   else ttomo.process_tilt_series(item, p, work, device="cpu"))
        out[pkg] = (summary, META[pkg]("ts01", work, mode="tomo").load())
    (js, j), (ts, t) = out["jax"], out["port"]
    assert ts["align_beads"] == js["align_beads"] >= 4
    assert ts["align_residual_px"] == pytest.approx(js["align_residual_px"],
                                                   abs=1e-2)
    np.testing.assert_allclose(t["fid"], j["fid"], atol=1e-2)
    np.testing.assert_allclose(t["xf"][:, :2], j["xf"][:, :2], atol=1e-2)
    np.testing.assert_array_equal(t["xf"][:, 2], j["xf"][:, 2])
    assert t.scalars[ttomo.XF_SIGN] == -1.0


def fork(src, dst, drop=("box",)):
    """A copy of a project whose bundle lacks `drop`."""
    shutil.copytree(src, dst)
    path = dst / "ts01.meta.npz"
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files if k not in drop}
    np.savez_compressed(path, **arrays)
    return dst


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_patch_bundles_resume_across_packages(writer, patched, series,
                                              tmp_path):
    """The other package reconstructs from the writer's patch bundle (its
    tomogram and picks dropped): the JAX package makes from the port's
    bundle the tomogram it made from its own, and the port reads the JAX
    bundle, which has no sign, as the JAX package reads it."""
    src = patched[writer][0]
    work = fork(src, tmp_path / "resume", drop=("box", "rec_done"))
    (work / "ts01.rec.mrc").unlink()
    reader = "port" if writer == "jax" else "jax"
    summary = _run(reader, series, work)
    assert "align_residual_px" not in summary
    back = META[reader]("ts01", work, mode="tomo").load()
    with np.load(src / "ts01.meta.npz") as z:
        np.testing.assert_array_equal(back["xf"], z["xf"])
    close(mrc.read(work / "ts01.rec.mrc"),
          mrc.read(patched["jax"][0] / "ts01.rec.mrc"))
