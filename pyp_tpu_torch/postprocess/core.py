"""Map postprocessing — the torch port of pyp_tpu/postprocess/core.py:
auto-masking, the mask-corrected FSC (phase randomization beyond a shell,
Chen et al. 2013), the Guinier B-factor (Rosenthal & Henderson 2003), MTF
division, sharpening, and `postprocess_latest`, the `postprocess` mode,
which writes the same files as the JAX package's.

Random phases come from a torch.Generator seeded as the JAX package seeds
its PRNG key (`_random_phases`); the two generators draw different
numbers, so the corrected FSC agrees with the JAX package's statistically,
and exactly where the phases are supplied."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from pyp_tpu_torch import as_f32, resolve_device
from pyp_tpu_torch.core import fsc as fsc_mod
from pyp_tpu_torch.core.filters import lowpass_filter_3d, soft_spherical_mask
from pyp_tpu_torch.utils import get_logger

logger = get_logger("postprocess")


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


def _random_phases(shape, seed: int, device):
    """Uniform phases in [0, 2 pi) of `shape` from a torch.Generator on
    `device` seeded with `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return torch.rand(shape, generator=gen, device=device) * (2.0 * np.pi)


def _phase_randomize(F, bins, cutoff_bin, seed=0):
    """Randomize the phases of a spectrum beyond a shell (for the
    mask-correction FSC)."""
    phases = torch.as_tensor(_random_phases(F.shape, seed, F.device),
                             dtype=torch.float32, device=F.device)
    rand = torch.polar(F.abs(), phases)
    return torch.where(bins > cutoff_bin, rand, F)


def masked_fsc(half1, half2, mask, pixel_size, rand_res_a=10.0, seed=0):
    """Mask-corrected FSC ("part FSC") of two half-map tensors: the masked
    FSC with noise substitution beyond the randomization shell. Returns
    (freqs, corrected_curve). `seed` offsets the randomization."""
    n = half1.shape[-1]
    n_bins = n // 2
    freqs, fsc_masked = fsc_mod.fsc(half1 * mask, half2 * mask, n_bins)
    cutoff_bin = int(round((pixel_size / rand_res_a) / 0.5 * n_bins))
    cutoff_bin = min(max(cutoff_bin, 2), n_bins - 2)
    bins3 = fsc_mod._shell_bins(n, n_bins, half1.device).reshape(
        n, n, n // 2 + 1)
    r1 = torch.fft.irfftn(_phase_randomize(torch.fft.rfftn(half1), bins3,
                                           cutoff_bin, 1 + 2 * int(seed)),
                          s=half1.shape)
    r2 = torch.fft.irfftn(_phase_randomize(torch.fft.rfftn(half2), bins3,
                                           cutoff_bin, 2 + 2 * int(seed)),
                          s=half2.shape)
    _, fsc_rand = fsc_mod.fsc(r1 * mask, r2 * mask, n_bins)
    return freqs, fsc_mod.part_fsc(fsc_masked, fsc_rand, cutoff_bin + 2)


def _radial_amplitude(vol, pixel_size):
    """(g in 1/Å at shell centres, RMS amplitude per shell) of a map."""
    n = vol.shape[-1]
    n_bins = n // 2
    amps2 = torch.fft.rfftn(vol).abs() ** 2
    bins = fsc_mod._shell_bins(n, n_bins, vol.device)
    sums = fsc_mod._shell_sum(amps2.reshape(-1), bins, n_bins)
    counts = fsc_mod._shell_sum(torch.ones_like(amps2.reshape(-1)), bins,
                                n_bins)
    amp = torch.sqrt(sums / torch.clamp(counts, min=1.0))
    g = ((torch.arange(n_bins, dtype=torch.float32, device=vol.device) + 0.5)
         * 0.5 / n_bins / pixel_size)
    return g, amp


def guinier_bfactor(vol, pixel_size, min_res=10.0, max_res=None):
    """Automatic B-factor (float, Å²) from the Guinier plot slope of a map
    tensor: fit ln|F|(g^2) in [1/min_res, 1/max_res]; B = 4 * slope."""
    if max_res is None:
        max_res = 2.5 * pixel_size
    g, amp = _radial_amplitude(vol, pixel_size)
    w = ((g > 1.0 / min_res) & (g < 1.0 / max_res) & (amp > 0)).to(
        torch.float32)
    x = g * g
    y = torch.log(torch.clamp(amp, min=1e-12))
    xm = torch.sum(x * w) / torch.clamp(torch.sum(w), min=1.0)
    ym = torch.sum(y * w) / torch.clamp(torch.sum(w), min=1.0)
    slope = torch.sum(w * (x - xm) * (y - ym)) / torch.clamp(
        torch.sum(w * (x - xm) ** 2), min=1e-12)
    return float(4.0 * slope)  # negative for falling amplitudes


def guinier_curve(vol, pixel_size):
    """Spherically averaged (1/d², ln|F|) table of a map tensor, as numpy
    arrays, for Guinier plotting."""
    g, amp = _radial_amplitude(vol, pixel_size)
    return ((g * g).cpu().numpy(),
            torch.log(torch.clamp(amp, min=1e-12)).cpu().numpy())


def read_mtf_curve(path):
    """Detector MTF curve as (freqs cycles/pixel, values), from a RELION
    MTF star (_rlnResolutionInversePixel / _rlnMtfValue) or a 2-column
    text table."""
    p = str(path)
    if p.endswith(".star"):
        from pyp_tpu_torch.io import star as star_mod

        blocks = star_mod.read(p)
        loop = next(b["loop"] for b in blocks.values() if b["loop"])
        f = np.asarray(loop["rlnResolutionInversePixel"], dtype=np.float64)
        v = np.asarray(loop["rlnMtfValue"], dtype=np.float64)
    else:
        table = np.loadtxt(p)
        f, v = table[:, 0], table[:, 1]
    order = np.argsort(f)
    return f[order], v[order]


def mtf_correct(vol, pixel_size, mtf_path, mtf_angpix: float = 0.0):
    """Divide a map tensor's Fourier amplitudes by the detector MTF, whose
    frequency axis is cycles per original detector pixel (`mtf_angpix`,
    the map pixel by default)."""
    n = vol.shape[-1]
    if not mtf_angpix or mtf_angpix <= 0:
        mtf_angpix = pixel_size
    f_tab, v_tab = read_mtf_curve(mtf_path)
    fz = np.fft.fftfreq(n).reshape(n, 1, 1)
    fy = np.fft.fftfreq(n).reshape(1, n, 1)
    fx = np.fft.rfftfreq(n).reshape(1, 1, -1)
    r = np.sqrt(fz * fz + fy * fy + fx * fx)
    mtf = np.interp(r * mtf_angpix / pixel_size, f_tab, v_tab)
    mtf = np.maximum(mtf, 1e-2).astype(np.float32)  # guard the division
    vol = vol.to(torch.float32)
    F = torch.fft.rfftn(vol) / torch.as_tensor(mtf, device=vol.device)
    return torch.fft.irfftn(F, s=vol.shape)


def _g2_grid(n: int, pixel_size: float, device):
    fz = torch.fft.fftfreq(n, d=pixel_size, device=device).reshape(n, 1, 1)
    fy = torch.fft.fftfreq(n, d=pixel_size, device=device).reshape(1, n, 1)
    fx = torch.fft.rfftfreq(n, d=pixel_size, device=device).reshape(1, 1, -1)
    return fz * fz + fy * fy + fx * fx


def sharpen_map(vol, pixel_size, bfactor=None, resolution=None,
                fsc_curve=None, guinier_min_res: float = 10.0,
                guinier_max_res=None, bfactor_low=None, flatten_res=None,
                edge_width_px: float = 0.0, fsc_filter: str = "cref"):
    """Sharpen a map tensor: apply -B (the Guinier fit where bfactor is
    None), the FSC weighting ('cref' sqrt(2C/(1+C)) or 'fsc2' C²) and a
    cosine lowpass at `resolution`. Returns (map, bfactor).

    bfactor_low + flatten_res: the split B (bfactor_low below the
    flattening resolution, `bfactor` beyond it). edge_width_px: the
    lowpass edge width in Fourier pixels (0.01 of Nyquist-relative
    frequency by default)."""
    n = vol.shape[-1]
    if bfactor is None:
        bfactor = guinier_bfactor(vol, pixel_size, min_res=guinier_min_res,
                                  max_res=guinier_max_res)
        logger.info("auto B-factor: %.1f Å²", bfactor)
    F = torch.fft.rfftn(vol)
    g2 = _g2_grid(n, pixel_size, vol.device)
    if bfactor_low is not None and flatten_res:
        B = torch.where(g2 < (1.0 / float(flatten_res)) ** 2,
                        float(bfactor_low), float(bfactor))
        F = F * torch.exp(-0.25 * B * g2)
    else:
        F = F * torch.exp(-0.25 * float(bfactor) * g2)
    if fsc_curve is not None:
        c = torch.clamp(as_f32(fsc_curve, vol.device), 0.0, 1.0)
        w = c * c if fsc_filter == "fsc2" else fsc_mod.fsc_weights(c)
        F = F * fsc_mod.radial_shell_filter_3d((n, n, n), w)
    out = torch.fft.irfftn(F, s=vol.shape)
    if resolution is not None:
        width = (edge_width_px / n) if edge_width_px else 0.01
        out = lowpass_filter_3d(out, pixel_size, resolution, width=width)
    return out, bfactor


def _postprocess_mask(params, half1, half2, pixel, dev):
    """The sharpen-tab mask: a user file, a spherical shell (Å radii), or
    the auto mask with the chosen threshold strategy."""
    from pyp_tpu_torch.io import mrc

    user_mask = str(params.get("sharpen_mask") or "")
    outer_rad = float(params.get("sharpen_outer_mask_radius") or 0.0)
    mask_method = str(params.get("sharpen_masking_method") or "")
    if mask_method == "external" and not user_mask:
        logger.warning("masking_method=external but no sharpen_mask given; "
                       "falling back to auto-masking")
        mask_method = "auto"
    if mask_method == "auto":
        user_mask, outer_rad = "", 0.0
    if user_mask and Path(user_mask).exists():
        return as_f32(mrc.read(user_mask), dev)
    n_box = half1.shape[-1]
    if outer_rad > 0:
        mask = soft_spherical_mask(n_box, outer_rad / pixel, 4.0, device=dev)
        inner_rad = float(params.get("sharpen_inner_mask_radius") or 0.0)
        if inner_rad > 0:
            mask = mask * (1.0 - soft_spherical_mask(
                n_box, inner_rad / pixel, 4.0, device=dev))
        return mask
    tm = str(params.get("sharpen_masking_threshold_method") or "")
    thr_abs = (float(params.get("sharpen_automask_threshold") or 0.0)
               if tm in ("", "intensity") else 0.0)
    frac = (float(params.get("sharpen_automask_fraction") or 0.0)
            if tm in ("", "volume") else 0.0)
    sigmas = (float(params.get("sharpen_automask_sigma") or 0.0)
              if tm in ("", "sigma") else 0.0)
    return auto_mask(
        half1 + half2, pixel_size=pixel,
        lowpass_a=float(params.get("sharpen_mask_lowpass") or 15.0),
        threshold_sigmas=sigmas or float(
            params.get("sharpen_mask_threshold") or 1.0),
        dilation_px=int(params.get("sharpen_mask_dilation") or 3),
        soft_px=int(params.get("sharpen_mask_soft") or 6),
        mw_kda=float(params.get("particle_mw") or 0.0),
        threshold_abs=thr_abs, volume_fraction=frac)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def postprocess_latest(dataset: str, params: dict, work_dir=".",
                       device="cuda") -> dict:
    """The `postprocess` mode on `device`: the newest maps/ half maps (or
    the explicit sharpen_first_half/second_half pair, or one
    sharpen_input_map without an FSC), optional MTF division, the mask,
    the mask-corrected FSC, sharpening, and the optional half-map,
    amplitude-correlation and local-resolution outputs. Writes
    maps/<dataset>_sharpened.mrc and _fsc_masked.txt (and the optional
    files) as the JAX package does; returns the same summary dict."""
    from pyp_tpu_torch.io import mrc

    dev = resolve_device(device)
    maps_dir = Path(work_dir) / "maps"
    h1_user = str(params.get("sharpen_first_half") or "")
    h2_user = str(params.get("sharpen_second_half") or "")
    single = str(params.get("sharpen_input_map") or "")
    if single and Path(single).exists():
        h1p = h2p = Path(single)
    elif h1_user and h2_user and Path(h1_user).exists() \
            and Path(h2_user).exists():
        h1p, h2p = Path(h1_user), Path(h2_user)
    else:
        halves = sorted(maps_dir.glob(f"{dataset}_r??_??_half1.mrc"))
        if not halves:
            raise FileNotFoundError(f"no half maps under {maps_dir}")
        h1p = halves[-1]
        h2p = Path(str(h1p).replace("half1", "half2"))
    maps_dir.mkdir(parents=True, exist_ok=True)
    half1 = as_f32(mrc.read(h1p), dev)
    half2 = as_f32(mrc.read(h2p), dev)
    have_halves = str(h1p) != str(h2p)
    pixel = mrc.read_header(h1p).pixel_size

    mtf_path = str(params.get("sharpen_mtf") or "")
    if mtf_path and Path(mtf_path).exists():
        angpix = float(params.get("sharpen_mtf_angpix") or 0.0)
        half1 = mtf_correct(half1, pixel, mtf_path, angpix)
        half2 = mtf_correct(half2, pixel, mtf_path, angpix)
        logger.info("MTF-corrected halves with %s", mtf_path)

    mask = _postprocess_mask(params, half1, half2, pixel, dev)
    hard_limit = float(params.get("sharpen_high_res_limit") or 0.0)
    if have_halves:
        rand_res = float(params.get("sharpen_rand_res") or 10.0)
        rand_fsc = float(params.get("sharpen_randomize_at_fsc") or 0.0)
        rmeth = str(params.get("sharpen_randomize_method") or "")
        if rmeth == "fsc" and rand_fsc <= 0:
            rand_fsc = 0.8
        elif rmeth == "resolution":
            rand_fsc = 0.0
        if rand_fsc > 0:
            # randomize where the unmasked FSC first crosses the value
            f0, c0 = fsc_mod.fsc(half1, half2)
            rand_res = float(fsc_mod.resolution_at_threshold(
                f0, c0, pixel, rand_fsc))
        freqs, curve = masked_fsc(
            half1, half2, mask, pixel, rand_res_a=rand_res,
            seed=int(params.get("sharpen_random_seed") or 0))
        res = float(fsc_mod.resolution_at_threshold(
            freqs, curve, pixel, float(params.get("sharpen_fsc_cut") or 0.143)))
    else:  # single-map input: no FSC; the hard limit is the lowpass
        freqs = torch.arange(half1.shape[-1] // 2, device=dev) / half1.shape[-1]
        curve = torch.ones_like(freqs)
        res = hard_limit or 2.5 * pixel
    if hard_limit > 0:
        res = max(res, hard_limit)
    combined = (half1 + half2) * 0.5
    bfac_user = float(params.get("sharpen_bfactor") or 0.0)
    if str(params.get("sharpen_bfactor_method") or "") == "auto":
        bfac_user = 0.0  # explicit auto overrides an adhoc leftover
    bfac_low = params.get("sharpen_low_res_bfactor")
    bfac_high = params.get("sharpen_high_res_bfactor")
    if bfac_high not in (None, "") and float(bfac_high) and not bfac_user:
        bfac_user = float(bfac_high)
    lowpass_res = res if params.get("sharpen_final_lowpass", True) else None
    sharp, bfac = sharpen_map(
        combined, pixel, resolution=lowpass_res,
        fsc_curve=(curve if params.get("sharpen_fsc_weight", True)
                   and have_halves else None),
        fsc_filter="fsc2" if params.get("sharpen_apply_fsc2") else "cref",
        bfactor=bfac_user if bfac_user else None,
        guinier_min_res=float(params.get("sharpen_bfac_lowres") or 10.0),
        guinier_max_res=(float(params.get("sharpen_bfac_highres"))
                         if params.get("sharpen_bfac_highres") else None),
        bfactor_low=(float(bfac_low)
                     if bfac_low not in (None, "", 0, 0.0) else None),
        flatten_res=float(params.get("sharpen_flatten_res") or 0.0) or None,
        edge_width_px=float(params.get("sharpen_edge_width") or 0.0))
    if params.get("plot_per_item", True):
        # Guinier panel of the pre-sharpen map with the applied B line
        try:
            from pyp_tpu_torch.analysis.plots import plot_guinier

            g2, ln_amp = guinier_curve(combined, pixel)
            lo = 1.0 / float(params.get("sharpen_bfac_lowres") or 10.0)
            band = (g2 > lo * lo) & np.isfinite(ln_amp)
            slope = float(bfac) / 4.0
            icpt = (float(np.mean(ln_amp[band] - slope * g2[band]))
                    if band.any() else 0.0)
            plot_guinier(g2[band], ln_amp[band], slope, icpt,
                         maps_dir / f"{dataset}_guinier.png")
        except (ImportError, OSError, ValueError) as e:
            logger.warning("guinier plot skipped: %s", e)
    if params.get("sharpen_gaussian"):
        # gaussian lowpass reaching 0.5 at the measured resolution
        g2 = _g2_grid(sharp.shape[-1], pixel, dev)
        gauss = torch.exp(-float(np.log(2.0)) * g2 * res * res)
        sharp = torch.fft.irfftn(torch.fft.rfftn(sharp) * gauss,
                                 s=sharp.shape[-3:])
    hp = float(params.get("sharpen_highpass") or -1.0)
    if hp > 0:
        sharp = sharp - lowpass_filter_3d(sharp, pixel, hp)
    apply_mask = params.get("sharpen_apply_mask", True)
    out_map = maps_dir / f"{dataset}_sharpened.mrc"
    out_vol = sharp * mask if apply_mask else sharp
    if params.get("sharpen_invert_handedness"):
        out_vol = out_vol.flip(0)   # mirror through the xy plane
    for key, ax in (("sharpen_flip_z", 0), ("sharpen_flip_y", 1),
                    ("sharpen_flip_x", 2)):
        if params.get(key):
            out_vol = out_vol.flip(ax)
    mrc.write(_np(out_vol).astype(np.float32), out_map, pixel_size=pixel)
    np.savetxt(maps_dir / f"{dataset}_fsc_masked.txt",
               np.stack([_np(freqs) / pixel, _np(curve)], 1),
               header="freq_1_per_A fsc_corrected")
    out = {"resolution_A": res, "bfactor": float(bfac), "map": str(out_map),
           "halves": [str(h1p), str(h2p)]}
    if params.get("sharpen_ampl_corr"):
        fa, ac, dpr = fsc_mod.amplitude_correlation_and_dpr(
            half1 * mask, half2 * mask)
        out["ampl_corr"] = str(maps_dir / f"{dataset}_ampl_corr.txt")
        np.savetxt(out["ampl_corr"],
                   np.stack([_np(fa) / pixel, _np(ac), _np(dpr)], 1),
                   header="freq_1_per_A amplitude_correlation dpr_deg")

    if params.get("sharpen_half_maps"):
        for tag, h in (("half1", half1), ("half2", half2)):
            sh, _ = sharpen_map(
                h, pixel, bfactor=float(bfac), resolution=lowpass_res,
                fsc_curve=(curve if params.get("sharpen_fsc_weight", True)
                           else None))
            hp_path = maps_dir / f"{dataset}_{tag}_postprocessed.mrc"
            mrc.write(_np(sh * mask if apply_mask else sh).astype(np.float32),
                      hp_path, pixel_size=pixel)
            out[f"{tag}_postprocessed"] = str(hp_path)

    if params.get("sharpen_locres"):
        from pyp_tpu_torch.postprocess.locres import (local_filter,
                                                      local_resolution)

        locres_map, _pts, vals = local_resolution(
            half1, half2, pixel,
            sampling_a=float(params.get("sharpen_locres_sampling") or 25.0),
            maskrad_a=float(params.get("sharpen_locres_maskrad") or -1.0),
            edgwidth_a=float(params.get("sharpen_locres_edgwidth") or -1.0),
            randomize_at_a=float(
                params.get("sharpen_locres_randomize_at") or 25.0),
            minres_a=float(params.get("sharpen_locres_minres") or 50.0),
            threshold=float(params.get("sharpen_fsc_cut") or 0.143),
            device=dev)
        max_res = float(params.get("sharpen_resmap_max_res") or 0.0)
        if max_res > 0:
            locres_map = torch.clamp(locres_map, min=max_res)
            vals = np.maximum(vals, max_res)
        locres_path = maps_dir / f"{dataset}_locres.mrc"
        mrc.write(_np(locres_map).astype(np.float32), locres_path,
                  pixel_size=pixel)
        out["locres_map"] = str(locres_path)
        out["locres_median_A"] = float(np.median(vals))
        if params.get("sharpen_locfilt", True):
            filt = local_filter(sharp, locres_map, pixel)
            if apply_mask:
                filt = filt * mask
            locfilt_path = maps_dir / f"{dataset}_locfilt.mrc"
            mrc.write(_np(filt).astype(np.float32), locfilt_path,
                      pixel_size=pixel)
            out["locfilt_map"] = str(locfilt_path)
        logger.info("locres: median %.2f Å over %d samples",
                    out["locres_median_A"], len(vals))

    logger.info("postprocess: %.2f Å, B=%.0f", res, bfac)
    return out
