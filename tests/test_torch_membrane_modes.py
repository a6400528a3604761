"""`-tomo_spk_method surface -tomo_vir_method nn` in both packages on
test_torch_tomo_pipeline.py's small planted series (its 32 x 64²
tomogram from the seeded bundle of test_torch_model_modes_tomo.py):
without a model the membrane network trains on procedural membranes
(from carried weights) and is saved to membrane_model.npz in the working
directory; with the JAX package's saved model both packages load it.

Tolerances: the saved kernels 1e-3 x max (two Adam steps of a (16, 32,
64) U-Net: float noise scaled by the first steps' normalization), the
networks' outputs 1e-3 x max; virion rows and surface picks within 1e-3
(as sets).
"""

import shutil

import numpy as np
import pytest

from tests.test_torch_model_modes import assert_unet_files_agree
from tests.test_torch_model_modes_tomo import _both, seeded
from tests.test_torch_models import unet_init
from tests.test_torch_tomo_pipeline import _two_threads, series

assert _two_threads and series and seeded   # module fixtures shared
SURFACE = dict(tomo_rec_thickness=192, tomo_spk_method="surface",
               tomo_vir_method="nn",
               tomo_vir_rad=300.0, tomo_vir_sh_iters=5, tomo_vir_points=40,
               tomo_vir_nn_steps=2, tomo_mem_patch_pxl=32)


def _assert_virions_agree(out):
    (jw, js, j), (tw, ts, t) = out["jax"], out["port"]
    assert ts["particles"] == js["particles"]
    for key in ("vir", "box"):
        assert (key in t.entries()) == (key in j.arrays), key
        if key in j.arrays:
            a, b = np.asarray(t[key]), np.asarray(j[key])
            assert a.shape == b.shape, key
            order = (np.lexsort(a[:, 2::-1].T), np.lexsort(b[:, 2::-1].T))
            np.testing.assert_allclose(a[order[0]], b[order[1]], atol=1e-3)


@pytest.fixture(scope="module")
def membrane_runs(series, seeded, tmp_path_factory):
    root = tmp_path_factory.mktemp("membrane")
    with pytest.MonkeyPatch.context() as mp:
        out = _both(series, seeded, root, mp,
                    {"UNet2D": unet_init((16, 32, 64))}, **SURFACE)
    return out


def test_vir_method_nn_trains_and_saves_the_membrane_model(membrane_runs):
    (jw, js, _), (tw, _, _) = membrane_runs["jax"], membrane_runs["port"]
    assert js["particles"] > 0
    assert_unet_files_agree(tw / "membrane_model.npz",
                            jw / "membrane_model.npz", (16, 32, 64), rel=1e-3)
    _assert_virions_agree(membrane_runs)


def test_vir_method_nn_reads_a_saved_model(membrane_runs, series, seeded,
                                           tmp_path, monkeypatch):
    """Both packages read the JAX package's membrane_model.npz and find
    the same virions."""
    model = membrane_runs["jax"][0] / "membrane_model.npz"
    for pkg in ("jax", "port"):
        (tmp_path / pkg).mkdir()
        shutil.copy(model, tmp_path / pkg / "membrane_model.npz")
    out = _both(series, seeded, tmp_path, monkeypatch, {},
                **dict(SURFACE, tomo_vir_nn_steps=0))
    for pkg in ("jax", "port"):
        assert (tmp_path / pkg / "membrane_model.npz").read_bytes() == \
            model.read_bytes()
    _assert_virions_agree(out)
