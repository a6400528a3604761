"""Parity of pyp_tpu_torch.ops.ctf_fit against pyp_tpu.ops.ctf_fit on the
CPU: the same seeded numpy power spectra (512² tiles, a planted astigmatic
CTF² under a falling envelope plus noise) and micrographs go through the
JAX function and its torch port.

Tolerances: resampled and normalized spectra rtol 1e-4 with atol 1e-4 *
max|reference|; grid scores atol 1e-4 * max|score|; fitted defocus within
0.2 * dfstep of the JAX fit (each stage takes the argmax of a grid, and a
float32 rounding difference may move a near-tie by one cell of the last,
finest grid, 0.04 * dfstep wide), angle within 2°, cc within 1e-3 relative,
fit_res the same ring. Recovery tests hold the port alone to the planted
parameters.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyp_tpu.core import ctf as jctf
from pyp_tpu.ops import ctf_fit as jc
from pyp_tpu_torch.core import ctf as tctf
from pyp_tpu_torch.ops import ctf_fit as tc

SEARCH = dict(dfmin=5000.0, dfmax=40000.0, dfstep=250.0, min_res=25.0,
              max_res=3.5)


def close(port, ref, rtol=1e-4, atol_rel=1e-4):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    atol = atol_rel * max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol)


def synthetic_power(n=512, pixel=1.0, df1=21000.0, df2=19000.0, angast=35.0,
                    phase=0.0, noise=0.3, seed=0, voltage=300.0, thickness=0.0):
    """A power spectrum that looks like a periodogram: CTF² (optionally
    averaged over a sample depth) under an envelope, plus noise; numpy."""
    rng = np.random.RandomState(seed)
    fy = np.fft.fftfreq(n, d=pixel).reshape(n, 1)
    fx = np.fft.rfftfreq(n, d=pixel).reshape(1, -1)
    g = np.sqrt(fy ** 2 + fx ** 2)
    az = np.arctan2(fy, fx)
    v = voltage * 1e3
    lam = 12.2639 / np.sqrt(v + 0.97845e-6 * v * v)
    df = 0.5 * (df1 + df2 + (df1 - df2) * np.cos(2 * (az - np.radians(angast))))
    chi = np.pi * lam * g * g * df - 0.5 * np.pi * 2.7e7 * lam ** 3 * g ** 4 + phase
    amp = np.arctan2(0.07, np.sqrt(1 - 0.07 ** 2))
    c2 = 0.5 - 0.5 * np.cos(2 * (chi + amp)) * np.sinc(lam * g * g * thickness)
    envelope = np.exp(-g * 14.0)
    power = envelope * (0.5 + c2) + noise * np.abs(rng.randn(n, n // 2 + 1)) * envelope
    return power.astype(np.float32)


def fit_values(fit):
    return np.array([float(x) for x in fit])


def assert_fits_agree(out, ref, dfstep=250.0):
    o, r = fit_values(out), fit_values(ref)
    assert abs(o[0] - r[0]) <= 0.2 * dfstep and abs(o[1] - r[1]) <= 0.2 * dfstep, (o, r)
    if r[0] - r[1] > 200.0:
        assert abs((o[2] - r[2] + 90) % 180 - 90) <= 2.0, (o, r)
    assert abs(o[3] - r[3]) <= 0.05, (o, r)
    assert abs(o[4] - r[4]) <= 1e-3 * abs(r[4]), (o, r)
    assert abs(o[5] - r[5]) <= 1e-3 * r[5], (o, r)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def power():
    return synthetic_power()


def micrograph(n=512, seed=0, df=18000.0, astig=1500.0, angast=40.0):
    """White noise through an astigmatic CTF plus detector noise."""
    rng = np.random.RandomState(seed)
    c = tctf.ctf_2d((n, n), 1.0, torch.tensor(df + astig / 2),
                    torch.tensor(df - astig / 2), torch.tensor(angast),
                    300.0, 2.7, 0.07).numpy()
    img = np.fft.irfft2(np.fft.rfft2(rng.randn(n, n)) * c, s=(n, n))
    return (img + 0.5 * rng.randn(n, n)).astype(np.float32)


@pytest.mark.parametrize("tile,overlap,shape", [(128, 0.5, (512, 512)),
                                                (128, 0.0, (512, 384)),
                                                (256, 0.5, (300, 512)),
                                                (512, 0.5, (200, 260))])
def test_periodogram(tile, overlap, shape):
    mic = np.random.RandomState(0).randn(*shape).astype(np.float32)
    close(tc.periodogram(torch.from_numpy(mic), tile, overlap),
          jc.periodogram(jnp.asarray(mic), tile, overlap))


def test_polar_resample_normalize_and_profiles(power):
    P, g, th = tc.polar_resample(torch.from_numpy(power), 384, 64)
    P_ref, g_ref, th_ref = jc.polar_resample(jnp.asarray(power), 384, 64)
    close(P, P_ref)
    close(g, g_ref, atol_rel=1e-6)
    close(th, th_ref, atol_rel=1e-6)
    close(tc._normalize_spectrum(P, g, 6.0),
          jc._normalize_spectrum(P_ref, g_ref, 6.0), rtol=1e-3, atol_rel=1e-4)
    close(tc._radial_profile(torch.from_numpy(power), 100),
          jc._radial_profile(jnp.asarray(power), 100))
    x = np.random.RandomState(1).randn(200).astype(np.float32)
    for sigma in (3.0, 6.0):
        close(tc._gaussian_smooth_1d(torch.from_numpy(x), sigma),
              jc._gaussian_smooth_1d(jnp.asarray(x), sigma), atol_rel=1e-5)


def _rows(seed=0, n=300):
    rng = np.random.RandomState(seed)
    return np.stack([rng.uniform(5000, 40000, n), rng.uniform(0, 2000, n),
                     rng.uniform(0, np.pi, n), rng.uniform(0, 1.0, n)],
                    1).astype(np.float32)


@pytest.mark.parametrize("masked", [True, False])
def test_model_polar(masked):
    g = np.linspace(0, 0.5, 96).astype(np.float32)
    th = np.linspace(0, np.pi, 16, endpoint=False).astype(np.float32)
    p = _rows(n=20)
    mask = ((g > 0.04) & (g < 0.3)).astype(np.float32) if masked else None
    args = (1.1, 300.0, 2.7, 0.07)
    ref = jc._model_polar(jnp.asarray(g), jnp.asarray(th), *(jnp.asarray(p[:, i]) for i in range(4)),
                          *args, None if mask is None else jnp.asarray(mask))
    out = tc._model_polar(torch.from_numpy(g), torch.from_numpy(th),
                          *(torch.from_numpy(p[:, i]) for i in range(4)),
                          *args, None if mask is None else torch.from_numpy(mask))
    # phases reach hundreds of radians in float32
    close(out, ref, rtol=1e-2, atol_rel=2e-3)


@pytest.mark.parametrize("chunk", [None, 64, 300])
def test_score_grid(power, chunk):
    P_ref, g_ref, th_ref = jc.polar_resample(jnp.asarray(power), 192, 32)
    Pn_ref = jc._normalize_spectrum(P_ref, g_ref)
    mask = ((np.asarray(g_ref) > 0.04) & (np.asarray(g_ref) < 0.28)).astype(np.float32)
    p = _rows()
    ref = jc._score_grid(Pn_ref, g_ref, th_ref, jnp.asarray(mask),
                         jnp.asarray(p), 1.0, 300.0, 2.7, 0.07)
    out = tc._score_grid(torch.from_numpy(np.asarray(Pn_ref)),
                         torch.from_numpy(np.asarray(g_ref)),
                         torch.from_numpy(np.asarray(th_ref)),
                         torch.from_numpy(mask), torch.from_numpy(p),
                         1.0, 300.0, 2.7, 0.07, chunk=chunk)
    close(out, ref, rtol=1e-3, atol_rel=2e-4)


FIT_CASES = {
    "astig": dict(),
    "no_astig": dict(fit_astigmatism=False),
    "phase": dict(fit_phase=True, phase_steps=7),
    "known_astig": dict(known_astig=2000.0, known_astig_angle=35.0),
    "coarse_polar": dict(n_g=256, n_theta=32, lowres_1d=10.0, bg_sigma=4.0,
                         max_astig=3000.0),
}


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_fit_ctf(power, case):
    kw = {**SEARCH, **FIT_CASES[case]}
    ref = jc.fit_ctf(jnp.asarray(power), 1.0, **kw)
    out = tc.fit_ctf(power, 1.0, device="cpu", **kw)
    assert all(isinstance(x, torch.Tensor) and x.ndim == 0 for x in out)
    assert_fits_agree(out, ref)


@pytest.mark.parametrize("df1,df2,angast,voltage", [
    (21000.0, 19000.0, 35.0, 300.0),
    (12000.0, 12000.0, 0.0, 300.0),
    (32000.0, 28500.0, 120.0, 300.0),
    (16000.0, 14500.0, 80.0, 200.0),
])
def test_fit_ctf_recovers_planted_parameters(df1, df2, angast, voltage):
    """At 200 kV the fit must be told the voltage: the fit takes the
    scope's parameters, it does not assume 300 kV."""
    p = synthetic_power(df1=df1, df2=df2, angast=angast, voltage=voltage)
    fit = tc.fit_ctf(p, 1.0, voltage_kv=voltage, device="cpu", **SEARCH)
    assert abs(float(fit.df1) - df1) < 300.0 and abs(float(fit.df2) - df2) < 300.0
    if df1 - df2 > 500:
        assert abs((float(fit.angast) - angast + 90) % 180 - 90) < 8.0
    if voltage != 300.0:
        wrong = tc.fit_ctf(p, 1.0, device="cpu", **SEARCH)
        assert abs(float(wrong.df1 + wrong.df2) / 2 - (df1 + df2) / 2) > 1000.0


def test_fit_ctf_phase_recovery():
    p = synthetic_power(df1=15000.0, df2=15000.0, angast=0.0, phase=1.2,
                        noise=0.1)
    fit = tc.fit_ctf(p, 1.0, fit_phase=True, device="cpu", **SEARCH)
    assert abs(float(fit.phase_shift) - 1.2) < 0.35
    assert abs(float(fit.df1) - 15000.0) < 800.0


def test_fit_ctf_micrograph_and_tilt_series():
    mics = np.stack([micrograph(seed=s, df=d) for s, d in ((0, 18000.0),
                                                           (1, 24000.0))])
    kw = dict(tile=256, **SEARCH)
    ref = jc.fit_ctf_tilt_series(jnp.asarray(mics), 1.0, **kw)
    out = tc.fit_ctf_tilt_series(torch.from_numpy(mics), 1.0, device="cpu", **kw)
    for i in range(2):
        assert_fits_agree([x[i] for x in out], [x[i] for x in ref])
    assert abs(float(out.df1[1] + out.df2[1]) / 2 - 24000.0) < 400.0
    one = tc.fit_ctf_micrograph(mics[0], 1.0, device="cpu", **kw)
    np.testing.assert_allclose(fit_values(one), fit_values([x[0] for x in out]),
                               rtol=1e-6)


def test_avgrot_and_diagnostic_image(power):
    ref_fit = jc.fit_ctf(jnp.asarray(power), 1.0, **SEARCH)
    fit = tc.CtfFit(*(torch.tensor(float(x)) for x in ref_fit))
    pt = torch.from_numpy(power)
    for a, b in zip(tc.avgrot(pt, 1.0, fit, n_bins=128),
                    jc.avgrot(jnp.asarray(power), 1.0, ref_fit, n_bins=128)):
        assert isinstance(a, np.ndarray)
        close(a, b, rtol=1e-3, atol_rel=1e-4)
    for size in (512, 256):
        out = tc.diagnostic_image(pt, 1.0, fit, size=size)
        ref = jc.diagnostic_image(jnp.asarray(power), 1.0, ref_fit, size=size)
        assert out.dtype == np.float32 and out.shape == (size, size)
        # the model half holds sin² of float32 phases of hundreds of radians
        assert np.mean(np.abs(out - ref) > 2e-3) < 1e-3


def test_fit_thickness():
    """A 150 nm lamella, whose nodes lie inside the fit band."""
    p = synthetic_power(df1=18000.0, df2=18000.0, angast=0.0, noise=0.15,
                        thickness=1500.0)
    kw = dict(min_res=25.0, max_res=3.5, t_max=3000.0, n_steps=76)
    search = {**SEARCH, "dfmin": 10000.0, "dfmax": 30000.0,
              "fit_astigmatism": False}
    ref_fit = jc.fit_ctf(jnp.asarray(p), 1.0, **search)
    fit = tc.CtfFit(*(torch.tensor(float(x)) for x in ref_fit))
    t_ref, curve_ref = jc.fit_thickness(jnp.asarray(p), 1.0, ref_fit, **kw)
    t, curve = tc.fit_thickness(torch.from_numpy(p), 1.0, fit, **kw)
    close(curve, curve_ref, rtol=1e-3, atol_rel=1e-3)
    assert abs(t - t_ref) < 5.0, (t, t_ref)
    assert abs(t - 1500.0) < 200.0, t


def test_fit_ctf_local_and_defocus_at_positions():
    mic = micrograph(n=512, seed=3)
    kw = dict(grid=(2, 2), tile=128, **SEARCH)
    fits_ref, plane_ref = jc.fit_ctf_local(jnp.asarray(mic), 1.0, **kw)
    fits, plane = tc.fit_ctf_local(mic, 1.0, device="cpu", **kw)
    assert len(fits) == len(fits_ref) == 4
    for a, b in zip(fits, fits_ref):
        assert abs(float(a.df1 + a.df2) - float(b.df1 + b.df2)) / 2 <= 50.0
    mean_ref = np.mean([float(f.df1 + f.df2) / 2 for f in fits_ref])
    assert abs(tc.defocus_at_positions(plane, [[256, 256]])[0] - mean_ref) < 50.0
    pos = np.random.RandomState(0).uniform(0, 512, (6, 2))
    np.testing.assert_array_equal(tc.defocus_at_positions(plane_ref, pos),
                                  jc.defocus_at_positions(plane_ref, pos))


def test_ctf_1d():
    g = np.linspace(0, 0.4, 200).astype(np.float32)
    for kw in (dict(), dict(w=0.1, phase_shift_rad=0.7, bfactor=40.0)):
        close(tctf.ctf_1d(torch.from_numpy(g), 18000.0, 300.0, 2.7, **kw),
              jctf.ctf_1d(jnp.asarray(g), 18000.0, 300.0, 2.7, **kw),
              rtol=1e-3, atol_rel=1e-4)
