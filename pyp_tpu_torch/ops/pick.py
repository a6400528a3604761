"""Particle picking (2D) — size-matched blob detection, the torch port of
pyp_tpu/ops/pick.py: bandpass the micrograph around the particle scale,
mask contamination by intensity outliers, find local maxima with a
minimum-distance constraint, threshold by z-score. Also gold-bead detection
(high-contrast small blobs) for fiducial erasure, and hot-pixel removal.

Results have a fixed capacity: a coordinate array plus a validity mask, all
on the device of the computation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from pyp_tpu_torch import as_f32, resolve_device
from pyp_tpu_torch.core.filters import apply_bandpass


class PickResult(NamedTuple):
    coords: torch.Tensor   # (max_picks, 2) (y, x) pixel coordinates
    scores: torch.Tensor   # (max_picks,)
    valid: torch.Tensor    # (max_picks,) bool


def median(x, dim: int = -1):
    """Median along `dim`, the mean of the two middle values at an even
    count (numpy's convention; `torch.median` returns the lower one, and
    `torch.quantile` refuses inputs of more than 2^24 elements). One sort:
    on a card `torch.kthvalue` selects within one thread block per row,
    which is slow for rows of 2^24 values."""
    n = x.shape[dim]
    s = torch.sort(x, dim=dim).values
    hi = s.select(dim, n // 2)
    return hi if n % 2 else 0.5 * (s.select(dim, n // 2 - 1) + hi)


def _local_maxima(resp, radius: int):
    """Local-max mask via max pooling with an odd window of 2*radius+1: the
    square window's maximum is two 1-D passes (the ends pad with -inf)."""
    k = 2 * radius + 1
    x = resp.reshape((-1, 1) + resp.shape[-2:])
    mx = F.max_pool2d(x, (k, 1), stride=1, padding=(radius, 0))
    mx = F.max_pool2d(mx, (1, k), stride=1, padding=(0, radius))
    return resp >= mx.reshape(resp.shape)


def _disk_mean(img, radius: int):
    """Mean over a square window approximating a particle-sized disk: two
    1-D box sums with zero ends, divided by the full window area."""
    k = 2 * radius + 1
    x = img.reshape((-1, 1) + img.shape[-2:])
    s = F.avg_pool2d(x, (k, 1), stride=1, padding=(radius, 0),
                     count_include_pad=True)
    s = F.avg_pool2d(s, (1, k), stride=1, padding=(0, radius),
                     count_include_pad=True)
    return s.reshape(img.shape)


def pick_particles(
    micrograph,
    particle_radius_px: int = 32,
    max_picks: int = 512,
    min_distance_px: int | None = None,
    threshold_sigma: float = 1.0,
    edge_px: int = 32,
    invert: bool = True,
    mask_contamination: bool = True,
    band_low: float = 6.0,
    band_high: float = 1.5,
    disk_frac: float = 0.5,
    cont_sigma: float = 8.0,
    cont_scale: float = 4.0,
    device="cuda",
) -> PickResult:
    """Size-matched picking on one micrograph.

    invert=True assumes particles are dark (standard cryo-EM contrast);
    the response is the band-limited, disk-averaged (inverted) density.
    Picks come in order of falling score, equal scores by rising index;
    rows past the last candidate have score -inf and valid False.
    """
    dev = resolve_device(device)
    micrograph = as_f32(micrograph, dev)
    ny, nx = micrograph.shape
    img = -micrograph if invert else micrograph
    # band select the particle scale: pass 1/(band_low*r) .. 1/(band_high*r)
    low = 1.0 / (band_low * particle_radius_px)
    high = 1.0 / (band_high * particle_radius_px)
    band = apply_bandpass(img[None], low, high, low_width=low * 0.5, high_width=high * 0.3)[0]
    resp = _disk_mean(band, max(1, int(disk_frac * particle_radius_px)))

    if min_distance_px is None:
        min_distance_px = particle_radius_px
    is_max = _local_maxima(resp, int(min_distance_px))

    mu = resp.mean()
    sd = resp.std(correction=0) + 1e-8
    score = (resp - mu) / sd

    yy = torch.arange(ny, device=dev)[:, None]
    xx = torch.arange(nx, device=dev)[None, :]
    in_bounds = (
        (yy >= edge_px) & (yy < ny - edge_px) & (xx >= edge_px) & (xx < nx - edge_px)
    )
    cand = is_max & in_bounds & (score > threshold_sigma)
    # contamination mask: robust z of intensity at a much coarser scale than
    # the particle, so isolated particles dilute away and only large
    # ice/carbon patches trigger
    if mask_contamination:
        coarse = _disk_mean(img, int(cont_scale * particle_radius_px))
        med = median(coarse.reshape(-1))
        dev_abs = (coarse - med).abs()
        mad = median(dev_abs.reshape(-1)) + 1e-6
        cand &= ~(dev_abs > cont_sigma * 1.4826 * mad)
    flat_score = torch.where(cand, score, -torch.inf).reshape(-1)
    top_scores, top_idx = torch.topk(flat_score, max_picks)
    # equal scores by rising index: sort by index, then stably by score
    top_idx, order = torch.sort(top_idx)
    top_scores, order = torch.sort(top_scores[order], descending=True,
                                   stable=True)
    top_idx = top_idx[order]
    coords = torch.stack([top_idx // nx, top_idx % nx], dim=-1)
    return PickResult(coords=coords, scores=top_scores,
                      valid=torch.isfinite(top_scores))


def detect_gold_beads(
    micrograph, bead_radius_px: int = 8, max_beads: int = 256,
    threshold_sigma: float = 5.0, device="cuda",
) -> PickResult:
    """High-contrast small-blob detection for gold fiducials (dark, round,
    much higher contrast than particles). Used for erasure and for tilt
    alignment seeding."""
    return pick_particles(
        micrograph,
        particle_radius_px=bead_radius_px,
        max_picks=max_beads,
        min_distance_px=2 * bead_radius_px,
        threshold_sigma=threshold_sigma,
        edge_px=bead_radius_px,
        invert=True,
        mask_contamination=False,
        device=device,
    )


def erase_blobs(micrograph, coords, valid, radius_px: float):
    """Replace disks around coords with the image median (the reference's
    gold erasure fills with noise of the local background statistics; this
    is deterministic). micrograph: a 2D tensor; coords (N, 2) and valid
    (N,) on its device or convertible to it."""
    ny, nx = micrograph.shape
    dev = micrograph.device
    coords = torch.as_tensor(coords, device=dev)
    valid = torch.as_tensor(valid, device=dev)
    yy = torch.arange(ny, device=dev)[:, None]
    xx = torch.arange(nx, device=dev)[None, :]
    inside = torch.zeros((ny, nx), dtype=torch.bool, device=dev)
    for i in range(coords.shape[0]):
        d2 = (yy - coords[i, 0]) ** 2 + (xx - coords[i, 1]) ** 2
        inside |= (d2 <= radius_px * radius_px) & valid[i]
    return torch.where(inside, median(micrograph.reshape(-1)), micrograph)


def remove_hot_pixels(frames, sigmas: float = 8.0):
    """X-ray / hot-pixel removal: pixels deviating more than `sigmas`
    robust-sigma from the per-image median are replaced by a 3x3 local
    mean. frames: (F, ny, nx) or (ny, nx) tensor; frames are processed one
    at a time, so the temporaries stay one frame large."""
    x = frames.to(torch.float32)
    squeeze = x.ndim == 2
    if squeeze:
        x = x[None]
    out = torch.empty_like(x)
    for i in range(x.shape[0]):
        f = x[i]
        med = median(f.reshape(-1))
        dev_abs = (f - med).abs()
        thresh = sigmas * 1.4826 * median(dev_abs.reshape(-1)) + 1e-6
        # 3x3 mean of the neighbours (a plain box mean is fine because
        # isolated hot pixels contribute ~1/9 of the patch)
        local = F.avg_pool2d(f[None, None], 3, stride=1, padding=1,
                             count_include_pad=True)[0, 0]
        out[i] = torch.where(dev_abs > thresh, local, f)
    return out[0] if squeeze else out
