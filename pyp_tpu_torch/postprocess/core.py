"""Map postprocessing — the torch port of the part of
pyp_tpu/postprocess/core.py the refinement loop uses: `auto_mask`, the
reference mask of `refine_masking_method=auto`."""

from __future__ import annotations

import torch

from pyp_tpu_torch.core.filters import lowpass_filter_3d


def _quantile_linear(x, q: float):
    """q-quantile of a 1-D tensor with linear interpolation between order
    statistics (numpy's and jnp.quantile's default). torch.quantile
    refuses inputs over 2^24 elements, which a 256^3 map exceeds."""
    xs = torch.sort(x).values
    pos = q * (xs.numel() - 1)
    lo = int(pos)
    hi = min(lo + 1, xs.numel() - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def auto_mask(vol, lowpass_a=15.0, pixel_size=1.0, threshold_sigmas=1.0,
              dilation_px=3, soft_px=6, mw_kda=0.0, threshold_abs=0.0,
              volume_fraction=0.0):
    """Shape mask of a map (tensor, on its device): lowpass to `lowpass_a`,
    threshold, dilate by a (2*dilation_px+1)^3 box max, soften by a
    (2*soft_px+1)^3 zero-padded box mean, scale by 1.2 and clip to [0, 1].

    Threshold: `threshold_abs` (absolute density), else `volume_fraction`
    (the densest fraction of voxels), else, with mw_kda > 0, the density
    enclosing the expected molecular volume (~1210 Å^3/kDa) when that is
    under 30% of the box, else mean + threshold_sigmas * std."""
    vol = torch.as_tensor(vol, dtype=torch.float32)
    lp = lowpass_filter_3d(vol, pixel_size, lowpass_a)
    vox = int(1210.0 * (mw_kda or 0.0) / pixel_size ** 3)
    if threshold_abs:
        thr = torch.tensor(threshold_abs, dtype=lp.dtype, device=lp.device)
    elif volume_fraction and 0.0 < volume_fraction < 1.0:
        thr = _quantile_linear(lp.reshape(-1), 1.0 - volume_fraction)
    elif 0 < vox < lp.numel() * 0.3:
        thr = torch.sort(lp.reshape(-1)).values[-max(vox, 1)]
    else:
        thr = lp.mean() + threshold_sigmas * lp.std(correction=0)
    binary = (lp > thr).to(torch.float32)[None, None]
    k = 2 * dilation_px + 1
    dil = torch.nn.functional.max_pool3d(binary, k, stride=1, padding=k // 2)
    kk = 2 * soft_px + 1
    blur = torch.nn.functional.avg_pool3d(dil, kk, stride=1, padding=kk // 2,
                                          count_include_pad=True)
    return torch.clamp(blur[0, 0] * 1.2, 0.0, 1.0)
