"""The trained tomogram denoisers in both packages on
test_torch_tomo_pipeline.py's small planted series (13 tilts of 384² at
4 Å/px, a 32 x 64² tomogram): `process_tilt_series` with
`-denoise_method n2n` and `wedge`. The membrane network's option is in
test_torch_membrane_modes.py, `tomotrain` and `mine` in
test_torch_tomo_model_modes.py.

The series' bundle holds its tilt angles, zero shifts and the planted
defoci, so both packages go straight to the reconstruction (the same
tomogram) and the option. Both packages start from the same weights
(flax's init carried into the port) and draw the same batches.

Tolerances: the tomogram rtol 1e-3 with atol 1e-3 x max (as
test_torch_tomo_pipeline.py), the denoised volume 1e-3 x max (two
trainings' float noise through every slice).
"""

import shutil

import numpy as np
import pytest

from pyp_tpu.io.metadata import ItemMetadata as JMeta
from pyp_tpu_torch.io import mrc
from pyp_tpu_torch.io.metadata import ItemMetadata as TMeta
from tests.test_torch_models import carried_init, close, unet_init
from tests.test_torch_tomo_pipeline import _run, _two_threads, series

assert _two_threads and series   # module fixtures shared with that file
META = {"jax": JMeta, "port": TMeta}
THIN = dict(tomo_rec_thickness=192, tomo_spk_method="none")   # 32 slices


@pytest.fixture(scope="module")
def seeded(series, tmp_path_factory):
    """A project whose bundle holds the tilt angles, zero shifts and the
    planted defoci."""
    _, truth, tilts = series
    work = tmp_path_factory.mktemp("seeded")
    meta = JMeta("ts01", work, mode="tomo")
    meta["tlt"] = np.asarray(truth["angles"], np.float32)
    meta["xf"] = np.zeros((len(tilts), 3), np.float32)
    df = np.asarray(truth["defoci"], np.float32)
    meta["ctf"] = np.stack([df, df] + [np.zeros_like(df)] * 3, axis=1)
    meta.save()
    return work


def _both(series, seeded, root, monkeypatch, init, **kw):
    """The option in each package from a copy of the seeded project (the
    working directory too: the membrane model is written there)."""
    out = {}
    for pkg in ("jax", "port"):
        work = shutil.copytree(seeded, root / pkg, dirs_exist_ok=True)
        monkeypatch.chdir(work)
        with carried_init(**init):
            summary = _run(pkg, series, work, **kw)
        out[pkg] = (work, summary, META[pkg]("ts01", work, mode="tomo").load())
    return out


@pytest.mark.parametrize("method,features", [("n2n", (16, 32, 64)),
                                             ("wedge", (16, 32))])
def test_trained_tomogram_denoisers(method, features, series, seeded,
                                    tmp_path, monkeypatch):
    out = _both(series, seeded, tmp_path, monkeypatch,
                {"UNet2D": unet_init(features)}, denoise_method=method,
                denoise_epochs=2, denoise_patch=32, denoise_batch=4, **THIN)
    (jw, js, _), (tw, ts, _) = out["jax"], out["port"]
    assert ts["denoised"].endswith("ts01.den.mrc") and js["denoised"]
    rj, rt = mrc.read(jw / "ts01.rec.mrc"), mrc.read(tw / "ts01.rec.mrc")
    assert rt.shape == rj.shape == (32, 64, 64)
    np.testing.assert_allclose(rt, rj, rtol=1e-3,
                               atol=1e-3 * np.abs(rj).max())
    dj, dt = mrc.read(jw / "ts01.den.mrc"), mrc.read(tw / "ts01.den.mrc")
    assert np.isfinite(dt).all()
    close(dt, dj, rel=1e-3)
