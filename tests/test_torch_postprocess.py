"""Parity of pyp_tpu_torch.postprocess.core.auto_mask against
pyp_tpu.postprocess.core.auto_mask on the CPU (box 32 volumes of
tests/test_refine3d.py), for each threshold rule.

Tolerance: masks within 1e-5 absolute, and the same binary core (mask
> 0.99) — the threshold picks the same voxels on both sides; the linear
quantile equals numpy's to float32 precision."""

import numpy as np
import pytest
import torch
from test_refine3d import PIXEL, make_volume

from pyp_tpu.postprocess.core import auto_mask as j_auto_mask
from pyp_tpu_torch.postprocess.core import _quantile_linear, auto_mask


@pytest.fixture(scope="module")
def vol():
    return make_volume(seed=3)


@pytest.mark.parametrize("kw", [
    {},
    {"threshold_sigmas": 2.0, "dilation_px": 2, "soft_px": 3},
    {"volume_fraction": 0.1},
    {"threshold_abs": 0.5},
    {"mw_kda": 20.0, "lowpass_a": 10.0},
], ids=["sigma", "sigma2", "fraction", "absolute", "mw"])
def test_auto_mask(vol, kw):
    ref = np.asarray(j_auto_mask(vol, pixel_size=PIXEL, **kw))
    out = auto_mask(torch.from_numpy(vol), pixel_size=PIXEL, **kw).numpy()
    assert out.shape == ref.shape == vol.shape
    np.testing.assert_allclose(out, ref, atol=1e-5)
    np.testing.assert_array_equal(out > 0.99, ref > 0.99)
    assert 0.0 < (out > 0.99).mean() < 1.0


@pytest.mark.parametrize("q", [0.0, 0.3, 0.9, 1.0])
def test_quantile_linear(q):
    x = np.random.RandomState(0).randn(10_001).astype(np.float32)
    np.testing.assert_allclose(float(_quantile_linear(torch.from_numpy(x), q)),
                               np.quantile(x, q), rtol=1e-6)
