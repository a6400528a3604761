"""Model-map fit evaluation — the torch port of pyp_tpu/analysis/modelfit.py
(the Model-fitting tab: score a set of PDB coordinates against each
refinement iteration's map).

Atomic structure factors are evaluated directly on the map's rfft grid as
blocked complex-exponential sums,

    F_model(k) = sum_a w_a e^{-B_a |k|^2 / 4} e^{-2 pi i k . x_a},

so no density is gridded. Fit quality is the band-limited Fourier
correlation between F_model and the map's spectrum, and the optimal rigid
translation is the peak of one inverse FFT of F_map . conj(F_model).

Precision: the phases reach 2 pi * 0.5 * n rad, so float32 cos/sin carry
~1e-4 relative error at box 128 (the JAX package's float32 sums do too)."""

from __future__ import annotations

import numpy as np
import torch

from pyp_tpu_torch import resolve_device
from pyp_tpu_torch.core import fsc as fsc_mod

BLOCK = 16384  # grid points per block, the JAX package's


def _block_size(n_points: int, n_atoms: int, device) -> int:
    """Grid points per block: the JAX package's 16,384 on the CPU; on a
    card as many as fit an eighth of the free memory at ~16 bytes of
    temporaries per (point, atom) — more than 16,384 for a small model,
    fewer for a large one."""
    if device.type != "cuda":
        return BLOCK
    free, _ = torch.cuda.mem_get_info(device)
    return int(min(n_points, max(256, (free // 8) // (16 * max(n_atoms, 1)))))


def _structure_factors(coords_px, weights, bfac_px2, n: int):
    """F_model (n, n, n//2+1) complex on the rfftn grid of an n³ box, on
    the device of the inputs. coords_px (N, 3) in pixel units (z, y, x)
    from the box origin; weights (N,); bfac_px2 (N,) B in px²."""
    dev = coords_px.device
    kz = torch.fft.fftfreq(n, device=dev)
    kx = torch.fft.rfftfreq(n, device=dev)
    K = torch.stack(torch.meshgrid(kz, kz, kx, indexing="ij"), -1).reshape(-1, 3)
    G = K.shape[0]
    block = _block_size(G, coords_px.shape[0], dev)
    re = torch.empty(G, dtype=torch.float32, device=dev)
    im = torch.empty(G, dtype=torch.float32, device=dev)
    for lo in range(0, G, block):
        Kb = K[lo:lo + block]
        # k . x as three broadcast products (no matmul: a TF32 product
        # would round the phases)
        ph = -2.0 * np.pi * (Kb[:, 0:1] * coords_px[None, :, 0]
                             + Kb[:, 1:2] * coords_px[None, :, 1]
                             + Kb[:, 2:3] * coords_px[None, :, 2])
        k2b = torch.sum(Kb * Kb, dim=1)
        w = weights[None, :] * torch.exp(-0.25 * bfac_px2[None, :]
                                         * k2b[:, None])
        re[lo:lo + block] = torch.sum(w * torch.cos(ph), dim=1)
        im[lo:lo + block] = torch.sum(w * torch.sin(ph), dim=1)
    return torch.complex(re, im).reshape(n, n, n // 2 + 1)


def model_structure_factors(model: dict, pixel_size: float, n: int,
                            extra_bfactor_a2: float = 100.0, center_a=None,
                            device="cuda"):
    """PDB model dict (io.pdb.read_pdb) -> F_model on the map grid, on
    `device`. Coordinates map Å -> box pixels with the model centroid (or
    `center_a`) at the box centre; per-atom B-factors plus a
    resolution-matched extra B shape the Gaussian-atom envelope."""
    dev = resolve_device(device)
    xyz = np.asarray(model["coords"], dtype=np.float32)       # (N, 3) xyz Å
    center = (np.mean(xyz, axis=0) if center_a is None
              else np.asarray(center_a, np.float32))
    zyx = (xyz - center)[:, ::-1] / pixel_size + n // 2
    bf_px2 = (np.asarray(model["bfactors"], np.float32)
              + float(extra_bfactor_a2)) / (pixel_size ** 2)

    def on(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32),
                               device=dev)

    return _structure_factors(on(zyx), on(model["weights"]), on(bf_px2), n)


def model_map_fit(model: dict, vol, pixel_size: float, low_res: float = 100.0,
                  high_res: float = 8.0, extra_bfactor_a2: float = 100.0,
                  device="cuda"):
    """Score a PDB model against a map (numpy or tensor) on `device`.
    Returns {"cc": band-limited Fourier correlation at the
    translation-optimal placement, "shift_px": (z, y, x) int32 rigid
    translation of the model, "fsc": per-shell model-map correlation
    after the shift}."""
    dev = resolve_device(device)
    vol = torch.as_tensor(np.asarray(vol, dtype=np.float32)
                          if not isinstance(vol, torch.Tensor) else vol)
    vol = vol.to(device=dev, dtype=torch.float32)
    n = vol.shape[-1]
    Fmap = torch.fft.rfftn(vol)
    Fmod = model_structure_factors(model, pixel_size, n,
                                   extra_bfactor_a2=extra_bfactor_a2,
                                   device=dev)
    kz = np.fft.fftfreq(n)
    kx = np.fft.rfftfreq(n)
    r = np.sqrt(kz[:, None, None] ** 2 + kz[None, :, None] ** 2
                + kx[None, None, :] ** 2)
    lo, hi = pixel_size / low_res, pixel_size / high_res
    band = torch.as_tensor(((r >= lo) & (r <= hi)).astype(np.float32),
                           device=dev)
    # translation-optimal placement: peak of the phase-correlation map
    cc_map = torch.fft.irfftn(Fmap * Fmod.conj() * band, s=vol.shape)
    peak = int(torch.argmax(cc_map.reshape(-1)))
    shift = (np.asarray(np.unravel_index(peak, cc_map.shape)) + n // 2) % n \
        - n // 2
    KZ = torch.as_tensor(kz.astype(np.float32), device=dev)[:, None, None]
    KY = torch.as_tensor(kz.astype(np.float32), device=dev)[None, :, None]
    KX = torch.as_tensor(kx.astype(np.float32), device=dev)[None, None, :]
    ph = 2.0 * np.pi * (KZ * float(shift[0]) + KY * float(shift[1])
                        + KX * float(shift[2]))
    Fmod_s = Fmod * torch.complex(torch.cos(ph), -torch.sin(ph))
    cross = (Fmap * Fmod_s.conj()).real * band
    p1 = Fmap.abs() ** 2 * band
    p2 = Fmod_s.abs() ** 2 * band
    cc = float(cross.sum() / torch.sqrt(p1.sum() * p2.sum() + 1e-12))
    n_bins = n // 2
    bins = fsc_mod._shell_bins(n, n_bins, dev)
    snum = fsc_mod._shell_sum(cross.reshape(-1), bins, n_bins)
    sp1 = fsc_mod._shell_sum(p1.reshape(-1), bins, n_bins)
    sp2 = fsc_mod._shell_sum(p2.reshape(-1), bins, n_bins)
    fsc = (snum / torch.clamp(torch.sqrt(sp1 * sp2), min=1e-12)).cpu().numpy()
    return {"cc": cc, "shift_px": shift.astype(np.int32), "fsc": fsc}
