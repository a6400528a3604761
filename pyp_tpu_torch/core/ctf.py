"""Contrast transfer function model (CTFFIND4/5 conventions) — the torch
port of the parts of pyp_tpu/core/ctf.py the refinement slice uses.

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
