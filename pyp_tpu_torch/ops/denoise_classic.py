"""Classical (training-free) tomogram denoisers — the torch port of
pyp_tpu/ops/denoise_classic.py, the reference's post-reconstruction
denoise tab (method bm4d / nad / imod-nad, nsearch, patch_size, sigma,
iters):

* `nlm_denoise_3d` (bm4d block-matching role): non-local means over a
  search window; for each search offset d the patch distance field is a
  box filter of (v - shift(v, d))^2, three separable 1-D passes;
* `nad_denoise_3d` (IMOD nad_eed_3d role): Perona-Malik anisotropic
  diffusion, an iterated 6-neighbour stencil.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pyp_tpu_torch import as_f32, resolve_device


def _box_filter_3d(x, k: int):
    """Separable (k, k, k) mean filter with XLA's "SAME" padding: an even
    window pads (k-1)//2 zeros before and k//2 after on each axis."""
    if k <= 1:
        return x
    lo, hi = (k - 1) // 2, k // 2
    v = x[None, None]
    for ax in range(3):
        pad = [0, 0, 0, 0, 0, 0]
        pad[2 * (2 - ax)], pad[2 * (2 - ax) + 1] = lo, hi
        win = [1, 1, 1]
        win[ax] = k
        v = F.avg_pool3d(F.pad(v, pad), tuple(win), stride=1)
    return v[0, 0]


def nlm_denoise_3d(vol, patch_size: int = 4, nsearch: int = 11,
                   sigma: float = 0.25, step: int = 2, device="cuda"):
    """Non-local means over a (nsearch)^3 offset window (bm4d role).

    sigma is in units of the volume's std; step subsamples the offset
    lattice. Offsets roll periodically, as `jnp.roll` does. Returns a
    tensor on `device`."""
    dev = resolve_device(device)
    v = as_f32(vol, dev)
    sd = v.std(correction=0) + 1e-12
    h2 = (sigma * sd) ** 2

    r = max(int(nsearch) // 2, 1)
    offs = [(dz, dy, dx)
            for dz in range(-r, r + 1, step)
            for dy in range(-r, r + 1, step)
            for dx in range(-r, r + 1, step)
            if not (dz == 0 and dy == 0 and dx == 0)]
    # centre voxel participates with weight 1
    num, den = v.clone(), torch.ones_like(v)
    for d in offs:
        shifted = torch.roll(v, shifts=d, dims=(0, 1, 2))
        dist = _box_filter_3d((v - shifted) ** 2, patch_size)
        # noise-compensated NLM weight: distances below 2 sigma^2 are
        # indistinguishable from noise and get full weight
        w = torch.exp(-torch.clamp(dist - 2.0 * h2, min=0.0) / (h2 + 1e-20))
        num += w * shifted
        den += w
    return num / den


def nad_denoise_3d(vol, iters: int = 8, sigma: float = 0.25,
                   lam: float = 0.125, device="cuda"):
    """Perona-Malik anisotropic diffusion (IMOD nad_eed_3d role): smooths
    flat regions while edges (gradients above K = sigma * std) survive."""
    dev = resolve_device(device)
    v = as_f32(vol, dev)
    K = sigma * (v.std(correction=0) + 1e-12)
    for _ in range(int(iters)):
        out = v
        for ax in (0, 1, 2):
            for s in (1, -1):
                g = torch.roll(v, s, dims=ax) - v
                c = torch.exp(-(g / K) ** 2)
                out = out + lam * c * g
        v = out
    return v


def denoise_map(vol, method: str = "bm4d", patch_size: int = 4,
                nsearch: int = 11, sigma: float = 0.25, iters: int = 1,
                device="cuda"):
    """Dispatch for the reference denoise tab (method bm4d / nad)."""
    dev = resolve_device(device)
    v = as_f32(vol, dev)
    if method in ("nad", "imod-nad"):
        return nad_denoise_3d(v, iters=max(int(iters) * 8, 8), sigma=sigma,
                              device=dev)
    out = v
    for _ in range(max(int(iters), 1)):
        out = nlm_denoise_3d(out, patch_size=patch_size, nsearch=nsearch,
                             sigma=sigma, device=dev)
    return out
