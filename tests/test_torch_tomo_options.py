"""`process_tilt_series` of both packages option by option on the CPU,
on test_torch_tomo_pipeline.py's small planted series (13 tilts of 384²
at 4 Å/px, a 64³ tomogram): the bundles, the written volumes and the
picks compared.

Each option of the pipeline (SART, the reconstruction flags, surface,
template and filament picking, membrane segmentation, bm4d, nad and
deconv) runs in each package from a copy of that package's own
prealignment run (no patches, axis 0, where both packages write the same
bundle). SART runs with the JAX package's update
(`ops.tomo.MIN_RAY_LENGTH = 0`). The tomogram is a cube because the JAX
package's spectral whitening of the template search handles cubes only
(ROADMAP Queue 3). The patch and bead paths are compared in
test_torch_tomo_paths.py.

Tolerances: volumes rtol 1e-3 with atol 1e-3 x max|reference| (the port
sums a WBP block's tilts, and SART's z planes, in another order than
JAX's scans); the segmentation masks equal but for at most 1e-5 of the
voxels (a threshold on a sum); picks equal as sets of (z, y, x), with
their scores, the virion rows and the eulers within 1e-3; the summaries'
handedness, membrane fraction and pick count equal.
"""

import numpy as np
import pytest

from pyp_tpu.io.metadata import ItemMetadata as JMeta
from pyp_tpu_torch.io import mrc
from pyp_tpu_torch.io.metadata import ItemMetadata as TMeta
from pyp_tpu_torch.ops import tomo as ttomo_ops
from pyp_tpu_torch.tools import e2e_tomo
from tests.test_torch_tomo_paths import fork, seed_ctf
from tests.test_torch_tomo_pipeline import (
    OPTIONS, _run, _two_threads, close, series)

assert _two_threads and series   # module fixtures shared with that file

META = {"jax": JMeta, "port": TMeta}
CUBE = dict(tomo_ali_patches=0, tomo_rec_thickness=384)
VOLUMES = {"sart": ["rec"], "reconstruction_flags": ["rec", "rec_half1",
                                                     "rec_half2"],
           "bm4d": ["rec", "den"], "nad": ["rec", "den"],
           "deconv": ["rec", "den"], "segmentation": ["seg"]}


@pytest.fixture(scope="module")
def prealigned(series, tmp_path_factory):
    """Both packages' prealignment runs from a bundle that holds the
    planted defoci (test_torch_tomo_pipeline.py compares the fits)."""
    out = {}
    for pkg in ("jax", "port"):
        work = seed_ctf(tmp_path_factory.mktemp(f"pre_{pkg}"),
                        series[1]["defoci"])
        _run(pkg, series, work, **CUBE)
        out[pkg] = work
    return out


def _in_zyx_order(box):
    return np.lexsort(box[:, 2::-1].T)


@pytest.mark.parametrize("option", list(OPTIONS))
def test_options_agree_with_jax(option, prealigned, series, tmp_path,
                                monkeypatch):
    monkeypatch.setattr(ttomo_ops, "MIN_RAY_LENGTH", 0.0)
    kw = dict(OPTIONS[option], **CUBE)
    if option == "template":
        ref = tmp_path / "ref.mrc"
        mrc.write(e2e_tomo.particle_map(series[1], 8, 24.0, device="cpu")
                  .numpy(), ref, pixel_size=24.0)
        kw["tomo_pick_ref"] = str(ref)
    if option in VOLUMES and option != "segmentation":
        kw["tomo_rec_force"] = True
    out = {}
    for pkg in ("jax", "port"):
        work = fork(prealigned[pkg], tmp_path / pkg)
        summary = _run(pkg, series, work, **kw)
        out[pkg] = (work, summary, META[pkg]("ts01", work, mode="tomo").load())
    (jw, js, j), (tw, ts, t) = out["jax"], out["port"]
    for v in VOLUMES.get(option, []):
        a, b = mrc.read(tw / f"ts01.{v}.mrc"), mrc.read(jw / f"ts01.{v}.mrc")
        if v == "seg":
            assert a.shape == b.shape and (a != b).mean() <= 1e-5
        else:
            close(a, b)
    for k in ("handedness", "membrane_fraction", "particles"):
        if k in ts or k in js:
            assert ts[k] == pytest.approx(js[k], rel=1e-6), k
    if option == "segmentation":
        return
    assert t.is_done("box") and j.is_done("box")
    kt, kj = _in_zyx_order(t["box"]), _in_zyx_order(j["box"])
    np.testing.assert_array_equal(t["box"][kt, :3], j["box"][kj, :3])
    np.testing.assert_allclose(t["box"][kt, 3], j["box"][kj, 3], rtol=1e-3,
                               atol=1e-3)
    if option == "surface":
        np.testing.assert_allclose(t["vir"], j["vir"], rtol=1e-3, atol=1e-3)
    assert t.is_done("spk_eulers") == j.is_done("spk_eulers")
    if t.is_done("spk_eulers"):
        np.testing.assert_allclose(t["spk_eulers"][kt], j["spk_eulers"][kj],
                                   atol=1e-3)

