"""Parity of pyp_tpu_torch.postprocess.core (and the FSC statistics and
dose weighting of pyp_tpu_torch.core) against the JAX package on the CPU,
at box 32 / 2 Å per pixel: half maps are a volume of tests/test_refine3d.py
plus independent noise.

Random phases: the port draws them from a torch.Generator, the JAX package
from jax.random, so the parity tests patch the port's `_random_phases` to
return JAX's phases (`jax_phases`); everything else is then held to float
tolerance. `test_masked_fsc_unpatched_agrees_statistically` compares the
unpatched port: the resolution within one Fourier shell.

Tolerances: masks within 1e-5 with the same binary core; FSC curves and
their corrections atol 1e-4 (written tables 2e-3); maps atol 1e-4 *
max|map|, sharpened maps 1e-3 * max|map| (the automatic B of these maps,
about -360 Å², amplifies the FFTs' rounding ~260x towards Nyquist);
B-factors rtol 1e-3; resolutions within 1e-3 Å (one shell in the
unpatched test)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_refine3d import N, PIXEL, make_volume

from pyp_tpu.core import ctf as jctf
from pyp_tpu.core import fsc as jfsc
from pyp_tpu.io import mrc
from pyp_tpu.postprocess import core as jpost
from pyp_tpu.postprocess.core import auto_mask as j_auto_mask
from pyp_tpu_torch.core import ctf as tctf
from pyp_tpu_torch.core import fsc as tfsc
from pyp_tpu_torch.postprocess import core as tpost
from pyp_tpu_torch.postprocess.core import _quantile_linear, auto_mask


def jax_phases(shape, seed, device):
    """The JAX package's phases for a seed, as the port's helper returns
    them."""
    ph = jax.random.uniform(jax.random.PRNGKey(int(seed)), tuple(shape),
                            minval=0.0, maxval=2 * np.pi)
    return torch.as_tensor(np.array(ph)).to(device)


@pytest.fixture
def same_phases(monkeypatch):
    monkeypatch.setattr(tpost, "_random_phases", jax_phases)


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def close(port, ref, atol_rel=1e-4):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    np.testing.assert_allclose(port, ref, rtol=0,
                               atol=atol_rel * float(np.abs(ref).max()))


@pytest.fixture(scope="module")
def vol():
    return make_volume(seed=3)


@pytest.fixture(scope="module")
def halves():
    rng = np.random.RandomState(11)
    sig = make_volume(seed=4)
    amp = 0.4 * sig.std()
    h1 = sig + amp * rng.randn(N, N, N).astype(np.float32)
    h2 = sig + amp * rng.randn(N, N, N).astype(np.float32)
    return sig, h1, h2


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


class TestFscStatistics:
    def test_part_fsc_and_ssnr(self):
        rng = np.random.RandomState(0)
        a = rng.uniform(-0.2, 1.0, 16).astype(np.float32)
        b = rng.uniform(-0.2, 0.9, 16).astype(np.float32)
        close(tfsc.part_fsc(t(a), t(b), 5), jfsc.part_fsc(a, b, 5), 1e-6)
        close(tfsc.fsc_to_ssnr(t(a)), jfsc.fsc_to_ssnr(jnp.asarray(a)), 1e-5)

    def test_amplitude_correlation_and_dpr(self, halves):
        _, h1, h2 = halves
        ref = jfsc.amplitude_correlation_and_dpr(h1, h2)
        out = tfsc.amplitude_correlation_and_dpr(t(h1), t(h2))
        for o, r in zip(out, ref):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-3)


class TestDoseWeighting:
    def test_dose_weight_2d_and_model_state(self):
        doses = np.array([2.0, 6.0, 14.0, 30.0], np.float32)
        close(tctf.dose_weight_2d((24, 32), 1.3, t(doses)),
              jctf.dose_weight_2d((24, 32), 1.3, jnp.asarray(doses)), 1e-5)
        g = np.linspace(0.0, 0.4, 50).astype(np.float32)
        close(tctf.critical_exposure(t(g)), jctf.critical_exposure(jnp.asarray(g)), 1e-5)
        try:
            tctf.set_dose_model(0.3, -1.5, 2.0)
            jctf.set_dose_model(0.3, -1.5, 2.0)
            close(tctf.dose_weight(t(g), 10.0), jctf.dose_weight(jnp.asarray(g), 10.0), 1e-5)
        finally:
            tctf.set_dose_model(0.24499, -1.6649, 2.8141)
            jctf.set_dose_model(0.24499, -1.6649, 2.8141)


class TestMaskedFsc:
    @pytest.mark.parametrize("rand_res,seed", [(10.0, 0), (16.0, 3)])
    def test_masked_fsc(self, halves, same_phases, rand_res, seed):
        _, h1, h2 = halves
        mask = np.asarray(j_auto_mask(h1 + h2, pixel_size=PIXEL))
        fr, ref = jpost.masked_fsc(h1, h2, mask, PIXEL, rand_res_a=rand_res,
                                   seed=seed)
        fo, out = tpost.masked_fsc(t(h1), t(h2), t(mask), PIXEL,
                                   rand_res_a=rand_res, seed=seed)
        close(fo, fr, 1e-6)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)

    def test_masked_fsc_unpatched_agrees_statistically(self, halves):
        """The port's own phases: the corrected FSC's resolution within one
        Fourier shell of the JAX package's."""
        _, h1, h2 = halves
        mask = np.asarray(j_auto_mask(h1 + h2, pixel_size=PIXEL))
        fr, ref = jpost.masked_fsc(h1, h2, mask, PIXEL)
        fo, out = tpost.masked_fsc(t(h1), t(h2), t(mask), PIXEL)
        rj = float(jfsc.resolution_at_threshold(fr, ref, PIXEL))
        rt = float(tfsc.resolution_at_threshold(fo, out, PIXEL))
        assert abs(1 / rj - 1 / rt) <= 1.0 / (N * PIXEL), (rj, rt)
        # below the randomization shell nothing is random: equal curves
        np.testing.assert_allclose(out.numpy()[:5], np.asarray(ref)[:5],
                                   atol=1e-4)


class TestGuinierAndSharpen:
    @pytest.mark.parametrize("kw", [{}, {"min_res": 15.0, "max_res": 6.0}])
    def test_guinier_bfactor_and_curve(self, halves, kw):
        # a half map: noise keeps every shell's amplitude well above the
        # FFT's rounding floor, where ln|F| is ill-conditioned
        _, h1, _ = halves
        ref = float(jpost.guinier_bfactor(h1, PIXEL, **kw))
        out = tpost.guinier_bfactor(t(h1), PIXEL, **kw)
        assert out == pytest.approx(ref, rel=1e-3)
        for o, r in zip(tpost.guinier_curve(t(h1), PIXEL),
                        jpost.guinier_curve(h1, PIXEL)):
            np.testing.assert_allclose(o, r, rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("kw", [
        {"bfactor": -80.0, "resolution": 6.0},
        {"resolution": 5.0},
        {"bfactor": -200.0, "bfactor_low": 0.0, "flatten_res": 8.0},
        {"bfactor": -50.0, "resolution": 6.0, "fsc": "cref", "edge_width_px": 3.0},
        {"bfactor": -50.0, "resolution": 6.0, "fsc": "fsc2"},
    ], ids=["adhoc", "auto", "split", "cref_edge", "fsc2"])
    def test_sharpen_map(self, halves, kw):
        _, h1, h2 = halves
        sig = 0.5 * (h1 + h2)
        kw = dict(kw)
        filt = kw.pop("fsc", None)
        if filt:
            _, curve = jfsc.fsc(jnp.asarray(h1), jnp.asarray(h2))
            kw.update(fsc_curve=np.asarray(curve), fsc_filter=filt)
        ref, bj = jpost.sharpen_map(sig, PIXEL, **kw)
        out, bt = tpost.sharpen_map(t(sig), PIXEL, **kw)
        close(out, ref, atol_rel=1e-3)
        assert bt == pytest.approx(float(bj), rel=1e-3)


class TestMtf:
    def _table(self, tmp_path, star):
        f_tab = np.linspace(0.0, 0.75, 40)
        v_tab = 1.0 / (1.0 + 4.0 * f_tab)
        if not star:
            p = tmp_path / "mtf.txt"
            np.savetxt(p, np.stack([f_tab, v_tab], 1))
            return p
        p = tmp_path / "mtf.star"
        rows = "".join(f"{f:.6f} {v:.6f}\n" for f, v in zip(f_tab, v_tab))
        p.write_text("data_mtf\n\nloop_\n_rlnResolutionInversePixel #1\n"
                     "_rlnMtfValue #2\n" + rows)
        return p

    @pytest.mark.parametrize("star", [False, True], ids=["txt", "star"])
    def test_mtf_correct(self, vol, tmp_path, star):
        p = self._table(tmp_path, star)
        for o, r in zip(tpost.read_mtf_curve(p), jpost.read_mtf_curve(p)):
            np.testing.assert_array_equal(o, r)
        close(tpost.mtf_correct(t(vol), PIXEL, p, mtf_angpix=1.5),
              jpost.mtf_correct(vol, PIXEL, p, mtf_angpix=1.5))


def _write_halves(work, h1, h2, name="ds_r01_03"):
    maps = work / "maps"
    maps.mkdir(parents=True, exist_ok=True)
    mrc.write(h1, maps / f"{name}_half1.mrc", pixel_size=PIXEL)
    mrc.write(h2, maps / f"{name}_half2.mrc", pixel_size=PIXEL)


POSTPROCESS_CASES = {
    "default": {},
    "strategies": {"sharpen_masking_threshold_method": "volume",
                   "sharpen_automask_fraction": 0.15,
                   "sharpen_randomize_method": "fsc",
                   "sharpen_apply_fsc2": True, "sharpen_gaussian": True,
                   "sharpen_highpass": 40.0, "sharpen_half_maps": True,
                   "sharpen_ampl_corr": True},
    "sphere_split_flip": {"sharpen_outer_mask_radius": 24.0,
                          "sharpen_inner_mask_radius": 4.0,
                          "sharpen_low_res_bfactor": -20.0,
                          "sharpen_high_res_bfactor": -120.0,
                          "sharpen_flatten_res": 10.0,
                          "sharpen_edge_width": 2.0, "sharpen_flip_x": True,
                          "sharpen_invert_handedness": True},
}


@pytest.mark.parametrize("case", list(POSTPROCESS_CASES))
def test_postprocess_latest(halves, tmp_path, same_phases, case):
    """Both packages' postprocess_latest on the same maps/ half maps: the
    same files, summary, masked FSC table and sharpened map."""
    _, h1, h2 = halves
    params = {"plot_per_item": False, **POSTPROCESS_CASES[case]}
    out = {}
    for name, fn in (("jax", jpost.postprocess_latest),
                     ("port", lambda d, p, w: tpost.postprocess_latest(
                         d, p, w, device="cpu"))):
        work = tmp_path / name
        _write_halves(work, h1, h2)
        out[name] = (fn("ds", dict(params), work), work)
    (oj, wj), (ot, wt) = out["jax"], out["port"]
    assert sorted(ot) == sorted(oj)
    assert sorted(p.name for p in (wt / "maps").iterdir()) == sorted(
        p.name for p in (wj / "maps").iterdir())
    assert ot["resolution_A"] == pytest.approx(oj["resolution_A"], abs=1e-3)
    assert ot["bfactor"] == pytest.approx(oj["bfactor"], rel=1e-3, abs=0.05)
    for name in ("ds_fsc_masked.txt", "ds_ampl_corr.txt"):
        if (wj / "maps" / name).exists():
            assert ((wt / "maps" / name).read_text().splitlines()[0]
                    == (wj / "maps" / name).read_text().splitlines()[0])
            np.testing.assert_allclose(np.loadtxt(wt / "maps" / name),
                                       np.loadtxt(wj / "maps" / name),
                                       atol=2e-3)
    for name in ("ds_sharpened.mrc", "ds_half1_postprocessed.mrc"):
        if (wj / "maps" / name).exists():
            close(mrc.read(wt / "maps" / name), mrc.read(wj / "maps" / name),
                  atol_rel=1e-3)


def test_postprocess_single_map_input(halves, tmp_path):
    """A single input map: no FSC, the hard limit is the lowpass."""
    _, h1, h2 = halves
    single = tmp_path / "one.mrc"
    mrc.write(((h1 + h2) / 2).astype(np.float32), single, pixel_size=PIXEL)
    params = {"sharpen_input_map": str(single), "plot_per_item": False,
              "sharpen_high_res_limit": 3.0 * PIXEL, "sharpen_apply_mask": False,
              "sharpen_fsc_weight": False}
    oj = jpost.postprocess_latest("ds", dict(params), tmp_path / "j")
    ot = tpost.postprocess_latest("ds", dict(params), tmp_path / "p",
                                  device="cpu")
    assert ot["resolution_A"] == oj["resolution_A"] == 3.0 * PIXEL
    close(mrc.read(ot["map"]), mrc.read(oj["map"]), atol_rel=1e-3)
