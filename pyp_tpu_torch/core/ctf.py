"""Contrast transfer function model (CTFFIND4/5 conventions) and the
Grant-Grigorieff dose weighting — the torch port of the parts of
pyp_tpu/core/ctf.py the SPA loop uses.

    chi(g, t) = pi * lambda * g^2 * df(t) - pi/2 * Cs * lambda^3 * g^4
                + phase_shift
    df(t)     = 0.5 * (df1 + df2 + (df1 - df2) * cos(2 * (t - angast)))

g in 1/Å, defocus in Å (positive = underfocus), Cs in mm, voltage in kV.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def wavelength(voltage_kv):
    """Relativistic electron wavelength in Å (voltage in kV), as a float32
    tensor (the JAX package evaluates it in float32 too)."""
    if isinstance(voltage_kv, torch.Tensor):
        v = voltage_kv.to(torch.float32) * 1e3
        return 12.2639 / torch.sqrt(v + 0.97845e-6 * v * v)
    v = float(voltage_kv) * 1e3
    return 12.2639 / torch.sqrt(torch.tensor(v + 0.97845e-6 * v * v,
                                             dtype=torch.float32))


def wavelength_host(voltage_kv: float) -> float:
    """Python-float wavelength in Å."""
    v = float(voltage_kv) * 1e3
    return 12.2639 / math.sqrt(v + 0.97845e-6 * v * v)


def defocus_at_azimuth(df1, df2, angast_deg, azimuth_rad):
    """Effective defocus (Å) at the given azimuth(s)."""
    ang = angast_deg * (np.pi / 180.0)
    return 0.5 * (df1 + df2 + (df1 - df2) * torch.cos(2.0 * (azimuth_rad - ang)))


def chi(g, df, voltage_kv, cs_mm, phase_shift_rad=0.0):
    """Aberration phase at frequency g (1/Å) and defocus df (Å)."""
    lam = wavelength(voltage_kv)  # 0-dim: combines with tensors anywhere
    cs = cs_mm * 1e7  # mm -> Å
    return (np.pi * lam * g * g * df
            - 0.5 * np.pi * cs * lam ** 3 * g ** 4
            + phase_shift_rad)


def ctf_1d(g, df, voltage_kv, cs_mm, w=0.07, phase_shift_rad=0.0,
           bfactor=0.0):
    """CTF along a radial profile g (1/Å, a tensor) at constant defocus."""
    x = chi(g, df, voltage_kv, cs_mm, phase_shift_rad)
    amp = math.atan2(w, math.sqrt(max(1.0 - w * w, 0.0)))
    return -torch.sin(x + amp) * torch.exp(-0.25 * bfactor * g * g)


def _fftfreq(n: int, pixel_size: float, rfft: bool, device):
    """np.fft.(r)fftfreq(n, d=pixel_size) in float32, computed as the JAX
    package computes it (integer wavenumbers divided by float32(n * d))."""
    k = np.fft.rfftfreq(n) * n if rfft else np.fft.fftfreq(n) * n
    return (torch.as_tensor(k.astype(np.float32), device=device)
            / torch.tensor(pixel_size * n, dtype=torch.float32, device=device))


def ctf_2d(shape, pixel_size, df1, df2, angast_deg, voltage_kv, cs_mm,
           w=0.07, phase_shift_rad=0.0, bfactor=0.0, rfft=True):
    """The 2D CTF on an FFT-layout grid: shape = (ny, nx) of the real-space
    image; the parameters are numbers or tensors broadcastable against each
    other, and the output has shape broadcast(params) + (ny, nx//2+1) with
    `rfft`, + (ny, nx) without (the full fftfreq layout)."""
    ny, nx = shape
    dev = next((p.device for p in (df1, df2, angast_deg, phase_shift_rad)
                if isinstance(p, torch.Tensor)), None)
    fy = _fftfreq(ny, pixel_size, False, dev).reshape(ny, 1)
    fx = _fftfreq(nx, pixel_size, rfft, dev).reshape(1, -1)
    g = torch.sqrt(fy * fy + fx * fx)
    azim = torch.atan2(fy, fx)

    def bc(p):
        return torch.as_tensor(p, dtype=torch.float32, device=dev)[..., None, None]

    df = defocus_at_azimuth(bc(df1), bc(df2), bc(angast_deg), azim)
    x = chi(g, df, voltage_kv, cs_mm, bc(phase_shift_rad))
    amp = math.atan2(w, math.sqrt(max(1.0 - w * w, 0.0)))
    out = -torch.sin(x + amp)
    if bfactor is not None:
        out = out * torch.exp(-0.25 * bc(bfactor) * g * g)
    return out


# ---------------------------------------------------------------------------
# dose weighting (Grant & Grigorieff 2015 critical-exposure model)
# ---------------------------------------------------------------------------

# Grant-Grigorieff critical-exposure constants, module state as in the JAX
# package; set_dose_model overrides them for other detectors/voltages
_DOSE_ABC = (0.24499, -1.6649, 2.8141)


def set_dose_model(a: float, b: float, c: float):
    global _DOSE_ABC
    _DOSE_ABC = (float(a), float(b), float(c))


def critical_exposure(g):
    """Critical exposure Ne(g) in e-/Å² at frequency g (1/Å, a tensor)."""
    a, b, c = _DOSE_ABC
    return a * torch.pow(torch.clamp(g, min=1e-6), b) + c


def dose_weight(g, cumulative_dose):
    """Per-frequency damage envelope exp(-dose / (2 Ne)). g: tensor in
    1/Å; cumulative_dose: broadcastable e-/Å² (dose at frame end)."""
    dose = torch.as_tensor(cumulative_dose, dtype=torch.float32,
                           device=g.device)
    return torch.exp(-dose / (2.0 * critical_exposure(g)))


def dose_weight_2d(shape, pixel_size, cumulative_doses, rfft=True,
                   device=None):
    """2D dose-weight filters (n_frames, ny, nx//2+1 with `rfft`) for a
    stack of frames, normalized so the sum of squares over frames is 1 at
    each frequency (keeps white-noise variance constant)."""
    ny, nx = shape
    if isinstance(cumulative_doses, torch.Tensor) and device is None:
        device = cumulative_doses.device
    fy = _fftfreq(ny, pixel_size, False, device).reshape(ny, 1)
    fx = _fftfreq(nx, pixel_size, rfft, device).reshape(1, -1)
    g = torch.sqrt(fy * fy + fx * fx)
    doses = torch.as_tensor(cumulative_doses, dtype=torch.float32,
                            device=g.device)
    w = dose_weight(g[None], doses[:, None, None])
    norm = torch.sqrt(torch.sum(w * w, dim=0, keepdim=True))
    return w / torch.clamp(norm, min=1e-8)


def frame_damage_weights(shape, frame_ranks, fraction: float = 4.0,
                         transition: float = 0.75, multiply: bool = True,
                         rfft=True, device=None):
    """Data-driven per-frame/tilt damage envelope (the reference's
    dose_weighting tab, merge/weights.py:76 `radDamage_weights`):

        Ne(g) = max_soft(exp(-|g|)^fraction, floor)   (tanh switch, not hard)
        w_f(g) = exp(-transition_eff * rank_f^4 / Ne(g))

    frame_ranks: (F,) damage order in [0, 1] (0 = least damaged).
    `fraction` steepens the frequency falloff, `transition` scales the
    rank falloff, `multiply` scales it by the frame count. |g| is the
    normalized radius in cycles/px. Output (F, ny, nxf) on `device`,
    normalized so the sum of squares over frames is 1."""
    ny, nx = shape
    fy = _fftfreq(ny, 1.0, False, device).reshape(ny, 1)
    fx = _fftfreq(nx, 1.0, rfft, device).reshape(1, -1)
    g = torch.sqrt(fy * fy + fx * fx)
    ne = torch.exp(-g) ** fraction
    floor = float(np.exp(-0.5 * fraction) ** 37.0)  # reference switch_value
    switch = floor ** (1.0 / 37.0)
    sx = 0.5 * (1.0 + torch.tanh((torch.exp(-g) - switch) / 0.05))
    ne = sx * ne + (1.0 - sx) * floor
    ranks = torch.as_tensor(np.asarray(frame_ranks, dtype=np.float32),
                            device=g.device)[:, None, None]
    t_eff = transition * (len(np.asarray(frame_ranks)) if multiply else 1.0)
    w = torch.exp(-t_eff * ranks ** 4 / ne[None])
    norm = torch.sqrt(torch.sum(w * w, dim=0, keepdim=True))
    return w / torch.clamp(norm, min=1e-8)
