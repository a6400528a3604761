"""Tilt-series (TOMO) preprocessing pipeline — the torch port of
pyp_tpu/pipeline/tomo.py, the reference's `tomo_swarm` worker: per tilt
series — per-tilt frame alignment (the .mdoc movie path), tilt-series
alignment (xcorr prealign + patch or gold-bead tracking + projection-model
solve), per-tilt CTF, tomogram reconstruction (WBP or SART) with the
optional bead erasure, dose weighting, handedness detection, CTF phase
flipping, even/odd halves and classical denoising, membrane segmentation
and 3D particle picking — with metadata-driven resume. The
`<name>.meta.npz` bundles and `<name>.rec.mrc` are the JAX package's, so
a series one package started resumes in the other.

The tilt stack is uploaded to the device once and stays there through
binning, alignment, CTF estimation and reconstruction; only what the
bundle stores and the written volumes come back to the host. A series
whose alignment, CTF and tomogram are all in the bundle is not read
again.

"xf" holds what the JAX package stores there: the prealignment's and an
imported .xf's aligning shifts, but minus the projection model's aligning
shifts on the patch and bead paths. The JAX package backprojects every
"xf" as aligning shifts, so its patch and bead tomograms are shifted the
wrong way, and it ignores the axis angle. The port records the sign of
what it stores in the bundle's scalar `xf_shift_sign` and reconstructs
from sign x "xf" with the tilts turned by the axis angle; a bundle
without the scalar (aligned by the JAX package) is read as the JAX
package reads it (ROADMAP Queue 3). The port's other departures from the
JAX package, each a defect of the latter recorded there: patches are
followed from tilt to tilt (`ops.tomo.TILT_TO_TILT`), SART floors the
ray length (`ops.tomo.MIN_RAY_LENGTH`), the template search whitens a
non-cubic tomogram and the WBP returns exactly `tomo_rec_thickness` /
binning slices. On the prealignment path with the axis at 0 both
packages write the same bundle (the port adds the scalar).

The trained denoisers (`denoise_method` n2n, on the even/odd-tilt half
tomograms, and wedge, the missing-wedge restorer) and the membrane
network of `tomo_vir_method nn` (loaded from membrane_model.npz or
trained on procedural membranes and saved there) are `models.denoise`
and `models.membrane`.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from pyp_tpu_torch import as_f32, resolve_device
from pyp_tpu_torch.io import mrc
from pyp_tpu_torch.io.metadata import ItemMetadata
from pyp_tpu_torch.utils import Timer, get_logger

logger = get_logger("tomo")

# the bundle scalar that gives the sign of the aligning shifts in "xf"
XF_SIGN = "xf_shift_sign"


def _denoise_method(params: dict) -> str:
    method = str(params.get("denoise_method") or "none")
    if method == "none" and params.get("denoise_enable"):
        method = "bm4d"  # reference denoise tab default method
    return method


def assemble_tilt_series(mdoc_path, params: dict, device="cuda") -> dict:
    """Assemble a tilt series from the per-tilt movies a SerialEM .mdoc
    lists: each tilt movie is uploaded once and frame-aligned on the
    device, the averages stack in tilt-angle order and stay there, and
    the cumulative exposure follows acquisition (ZValue) order. Returns an
    item dict for process_tilt_series: {"name", "tilts" (a tensor on the
    device), "angles", "doses", "order"}."""
    from pyp_tpu_torch.io import mdoc as mdoc_io
    from pyp_tpu_torch.ops import motion
    from pyp_tpu_torch.pipeline.spr import _upload, apply_gain, load_movie

    dev = resolve_device(device)
    mdoc_path = Path(mdoc_path)
    md = mdoc_io.read(mdoc_path)
    angles = np.asarray(mdoc_io.tilt_angles(md), dtype=np.float32)
    doses = np.asarray(mdoc_io.exposure_doses(md), dtype=np.float32)
    if not doses.any():
        doses = np.full(len(angles),
                        float(params.get("scope_dose_rate") or 1.0),
                        dtype=np.float32)
    paths = mdoc_io.subframe_paths(md)
    pixel = float(params["scope_pixel"])
    base = mdoc_path.parent

    avgs = []
    with Timer("tilt-series assembly"):
        for rel in paths:
            f = None
            for cand in (base / str(rel), base / Path(str(rel)).name):
                if cand.exists():
                    f = cand
                    break
            if f is None:
                raise FileNotFoundError(
                    f"tilt movie {rel!r} from {mdoc_path.name} not found in {base}"
                )
            frames = apply_gain(_upload(load_movie(f, params, dtype=None), dev),
                                params)
            if frames.shape[0] == 1:
                avgs.append(frames[0])
                continue
            common = dict(bfactor=float(params.get("movie_bfactor") or 1500.0),
                          max_iters=int(params.get("movie_iters") or 8),
                          smooth_order=int(params.get("movie_smooth_order") or 3))
            if frames.numel() > 300_000_000:  # the SPA path's memory guard
                res = motion.align_movie_large(frames, pixel_size=pixel,
                                               binning=2, device=dev, **common)
            else:
                res = motion.align_movie(
                    frames, pixel_size=pixel,
                    search_radius=float(params.get("movie_search") or 48.0),
                    device=dev, **common)
            avgs.append(res.average)
            del frames, res

    cum = np.cumsum(doses).astype(np.float32)  # acquisition order
    order = np.argsort(angles, kind="stable")
    return {
        "name": mdoc_path.name.replace(".mrc.mdoc", "").replace(".mdoc", ""),
        "tilts": torch.stack(avgs)[torch.as_tensor(order, device=dev)],
        "angles": angles[order],
        "doses": cum[order],
        # acquisition rank per sorted tilt: sorted tilt i came from
        # acquisition index order[i]
        "order": order.astype(np.int64),
    }


def _exclusions(item, meta, params, angles, tilts, name):
    """Tilt indices to drop: from the item, a prior edit, params
    "tomo_ali_exclude" ("3:7"), the angular window, and dark tilts."""
    excl = item.get("exclude")
    if excl is None and "exclude" in meta:
        excl = meta["exclude"].astype(int).tolist()
    if excl is None:
        raw = str(params.get("tomo_ali_exclude") or "").strip()
        excl = [int(x) for x in raw.split(":") if x] if raw else []
    lo_a = float(params.get("tomo_min_tilt", -90.0))
    hi_a = float(params.get("tomo_max_tilt", 90.0))
    if lo_a > -90.0 or hi_a < 90.0:
        excl = sorted(set(excl) | {
            int(i) for i in np.where((angles < lo_a) | (angles > hi_a))[0]})
    dark_tol = float(params.get("tomo_ali_aretomo_dark_tol") or 0.0)
    if dark_tol > 0 and tilts is not None:
        # auto-drop dark tilts (AreTomo -DarkTol role): mean intensity
        # below tol x the median tilt mean counts as dark
        means = tilts.reshape(tilts.shape[0], -1).mean(dim=1).cpu().numpy()
        means = means - means.min() + 1e-6  # tolerate negative-mean data
        dark = np.where(means < dark_tol * np.median(means))[0]
        if dark.size:
            logger.info("%s: dropping %d dark tilts (dark_tol %.2f)",
                        name, dark.size, dark_tol)
            excl = sorted(set(excl) | set(map(int, dark)))
    return excl


def _align(tilts_b, angles, params, meta, summary, item, name, binning,
           pixel_b, dev):
    """Tilt-series alignment into meta["xf"] (and meta["fid"])."""
    from pyp_tpu_torch.ops import tomo

    import_xf = str(params.get("tomo_ali_import_path") or "")
    if not meta.is_done("xf") and (params.get("tomo_ali_method") == "import"
                                   or import_xf):
        # external alignment import: the IMOD .xf next to the series (or
        # the explicit path)
        from pyp_tpu_torch.io.imod import read_xf

        xf_path = Path(import_xf) if import_xf else None
        if xf_path is not None and xf_path.is_dir():
            xf_path = xf_path / f"{name}.xf"
        if xf_path is None or not xf_path.exists():
            cand = Path(item.get("path") or ".").with_suffix(".xf")
            xf_path = cand if cand.exists() else None
        if xf_path is None:
            logger.warning("%s: no .xf found to import — aligning natively",
                           name)
        else:
            sh_xf, rot_xf = read_xf(xf_path)
            if sh_xf.shape[0] != len(angles):
                raise ValueError(
                    f"{xf_path}: {sh_xf.shape[0]} transforms for "
                    f"{len(angles)} tilts")
            meta["xf"] = np.concatenate(
                [sh_xf, rot_xf[:, None]], axis=1).astype(np.float32)
            meta.scalars[XF_SIGN] = 1.0
            summary["align_imported"] = str(xf_path)
    if meta.is_done("xf") or params.get("tomo_ali_method") in ("skip", "import"):
        return
    with Timer("tilt-series alignment"):
        shifts = tomo.prealign_tilt_series(
            tilts_b, angles,
            bp_low=float(params.get("tomo_ali_bp_low") or 0.01),
            bp_high=float(params.get("tomo_ali_bp_high") or 0.2), device=dev)
        sign = 1.0
        fid_nm = float(params.get("tomo_ali_fiducial") or 0.0)
        fid_done = False
        # nominal axis from the microscope config: the fallback when
        # neither beads nor patches constrain it
        axis_angle = float(params.get("scope_tilt_axis") or 0.0)
        fixed = axis_angle if params.get("ctf_tilt_axis_known") else None
        tukey = float(params.get("tomo_ali_robust_fitting_factor") or 1.0)
        if fid_nm > 0:
            bead_radius_px = max(2.0, fid_nm * 10.0 / (2.0 * pixel_b))
            try:
                model, coords, _tracks, _w = tomo.align_tilt_series_fiducial(
                    tilts_b, angles, bead_radius_px=bead_radius_px,
                    max_beads=int(params.get("tomo_ali_fiducial_n") or 40),
                    min_beads=int(params.get("tomo_ali_min_beads") or 4),
                    tukey_factor=tukey, fixed_alpha=fixed, device=dev)
                # stored negated, as the JAX package stores them
                shifts, sign = -np.asarray(model.shifts), -1.0
                axis_angle = float(model.axis_angle)
                summary["align_residual_px"] = float(model.residual) * binning
                summary["align_beads"] = int(coords.shape[0])
                meta["fid"] = np.asarray(coords) * binning
                fid_done = True
            except ValueError as e:
                logger.warning("%s: %s — falling back to patch tracking",
                               name, e)
        npatch = int(params.get("tomo_ali_patches") or 0)
        if not fid_done and npatch > 0:
            ny, nx = tilts_b.shape[-2:]
            ps = int(params.get("tomo_ali_patch_size") or 64)
            g = max(2, int(np.sqrt(npatch)))
            ys = np.linspace(ny * 0.25, ny * 0.75, g)
            xs = np.linspace(nx * 0.25, nx * 0.75, g)
            centers = np.array([(y, x) for y in ys for x in xs], dtype=np.float32)
            tracks = tomo.track_patches(tilts_b, shifts, angles, centers,
                                        patch_size=ps, device=dev)
            if params.get("tomo_ali_robust_fitting", True):
                model, _w = tomo.solve_projection_model_robust(
                    tracks, angles, (ny, nx), tukey_factor=tukey,
                    fixed_alpha=fixed)
            else:
                model = tomo.solve_projection_model(
                    tracks, angles, (ny, nx),
                    iters=int(params.get("tomo_ali_model_iters") or 5))
            shifts, sign = -np.asarray(model.shifts), -1.0
            axis_angle = float(model.axis_angle)
            summary["align_residual_px"] = float(model.residual) * binning
        meta["xf"] = np.concatenate(
            [np.asarray(shifts) * binning,
             np.full((len(angles), 1), axis_angle)], axis=1)
        meta.scalars[XF_SIGN] = sign


def _fit_ctf(tilts, params, pixel, meta):
    from pyp_tpu_torch.ops import ctf_fit

    with Timer("per-tilt CTF"):
        fits = ctf_fit.fit_ctf_tilt_series(
            tilts, pixel,
            tile=min(int(params.get("ctf_tile") or 512), min(tilts.shape[-2:])),
            dfmin=float(params["ctf_min_def"]),
            dfmax=float(params["ctf_max_def"]),
            dfstep=float(params["ctf_fstep"]),
            min_res=float(params["ctf_min_res"]),
            max_res=max(float(params["ctf_max_res"]), 8.0),
            device=tilts.device,
        )
        meta["ctf"] = torch.stack([fits.df1, fits.df2, fits.angast, fits.cc,
                                   fits.fit_res], dim=1).cpu().numpy()


def _erase_beads(t2, rad_px, factor):
    """Per tilt: detect gold beads and median-fill disks of factor x the
    bead radius (the reference's ccderaser pass)."""
    from pyp_tpu_torch.ops import pick

    out = []
    for t in t2:
        beads = pick.detect_gold_beads(t, bead_radius_px=max(2, int(rad_px)),
                                       device=t.device)
        out.append(pick.erase_blobs(t, beads.coords, beads.valid,
                                    factor * rad_px))
    return torch.stack(out)


def _reconstruct(t2, angles, item, params, meta, summary, work_dir, name,
                 pixel, binning, rec_bin, thickness, dev):
    """The reconstruction stage: bead erasure, dose weighting, handedness
    and CTF correction on the binned tilts, WBP or SART, halves and
    denoising; writes <name>.rec.mrc (and its siblings). Returns the
    tomogram tensor."""
    from pyp_tpu_torch.ops import tomo

    eff_px = pixel * binning * rec_bin
    xf = meta["xf"] if meta.is_done("xf") else np.zeros((len(angles), 3))
    shifts_r = (xf[:, :2] / (binning * rec_bin)).astype(np.float32)
    sign = meta.scalars.get(XF_SIGN) if meta.is_done("xf") else None
    if sign is None:
        if meta.is_done("xf"):
            logger.info("%s: xf without %s, read as the JAX package reads "
                        "it (no turn, shifts as stored)", name, XF_SIGN)
    elif float(xf[0, 2]):
        # turn the tilts so the tilt axis lies along y before anything
        # that assumes it does; the shifts go with the turn
        t2 = tomo.align_tilts(t2, np.float32(sign) * shifts_r,
                              float(xf[0, 2]), device=dev)
        shifts_r = None
    else:
        shifts_r = np.float32(sign) * shifts_r
    if params.get("tomo_rec_erase_fiducials"):
        rad_px = max(2.0, float(params.get("tomo_rec_gold_rad") or 100.0)
                     / eff_px)
        t2 = _erase_beads(t2, rad_px,
                          float(params.get("tomo_rec_erase_factor") or 1.5))
        summary["fiducials_erased"] = True
    # cumulative-dose weighting per tilt (mtffilter role); acquisition
    # order defaults to dose-symmetric (|angle| rank) without an order
    if params.get("tomo_rec_dose_weighting"):
        from pyp_tpu_torch.core.ctf import dose_weight_2d

        cum = item.get("doses")  # true cumulative e/Å² (mdoc)
        if cum is None:
            order = item.get("order")
            if order is None:
                order = np.argsort(np.argsort(np.abs(angles)))
            dose_per = float(params.get("scope_dose_rate") or 1.0)
            cum = (float(params.get("scope_init_dose") or 0.0)
                   + (np.asarray(order, dtype=np.float32) + 1.0) * dose_per)
        w = dose_weight_2d(t2.shape[-2:], eff_px,
                           as_f32(np.asarray(cum, dtype=np.float32), dev))
        t2 = torch.fft.irfft2(torch.fft.rfft2(t2) * w, s=t2.shape[-2:])
        summary["dose_weighted"] = True
    erase_a = float(params.get("tomo_rec_erase_rad") or 0.0)
    if erase_a > 0:
        er_px = max(2, int(erase_a / eff_px))
        t2 = _erase_beads(t2, er_px,
                          float(params.get("tomo_rec_erase_factor") or 1.5))
    # handedness + depth-dependent CTF correction from the per-tilt fits,
    # on tilts whose axis lies along y
    if meta.is_done("ctf") and np.asarray(meta["ctf"]).ndim == 2:
        ctf_t = np.asarray(meta["ctf"], dtype=np.float32)
        df_axis = 0.5 * (ctf_t[:, 0] + ctf_t[:, 1])
        if params.get("tomo_hand_detect"):
            hand, _grads = tomo.detect_handedness(
                t2, angles, df_axis, eff_px,
                voltage_kv=float(params["scope_voltage"]),
                cs_mm=float(params["scope_cs"]), w=float(params["scope_wgh"]),
                min_tilt=float(params.get("tomo_hand_min_tilt") or 20.0),
                max_tilt=float(params.get("tomo_hand_max_tilt") or 90.0),
                df_range=float(params.get("tomo_hand_df_range") or 8000.0),
                df_step=float(params.get("tomo_hand_df_step") or 250.0),
                device=dev)
            summary["handedness"] = int(hand)
            logger.info("%s: defocus handedness %+d", name, int(hand))
        if params.get("tomo_rec_ctf_correct"):
            t2 = tomo.ctf_correct_tilts(
                t2, angles, df_axis, eff_px,
                voltage_kv=float(params["scope_voltage"]),
                cs_mm=float(params["scope_cs"]),
                amplitude_contrast=float(params["scope_wgh"]),
                n_bands=int(params.get("tomo_rec_ctf_bands") or 20),
                device=dev)
            summary["ctf_corrected"] = True
    slab = min(int(params.get("tomo_rec_slab") or 16), thickness)
    if str(params.get("tomo_rec_method") or "wbp") == "sart":
        recon = tomo.sart_reconstruct(
            t2, angles, shifts=shifts_r, thickness=thickness,
            iterations=int(params.get("tomo_rec_sart_iters") or 10),
            relax=float(params.get("tomo_rec_sart_relax") or 0.25),
            subsets=int(params.get("tomo_rec_sart_subsets") or 4), device=dev)
    else:
        recon = tomo.wbp_reconstruct(
            t2, angles, shifts=shifts_r, thickness=thickness,
            cutoff=float(params.get("tomo_rec_filter_cutoff") or 0.35),
            falloff=float(params.get("tomo_rec_filter_falloff") or 0.05),
            slab=slab, fake_sirt=int(params.get("tomo_rec_fake_sirt") or 0),
            window=str(params.get("tomo_rec_filter_window") or "none"),
            z_shift=float(params.get("tomo_rec_zshift") or 0.0), device=dev)
    rec_dtype = np.float16 if params.get("tomo_rec_float16") else np.float32
    rec_path = f"{work_dir}/{name}.rec.mrc"
    mrc.write(recon.cpu().numpy().astype(rec_dtype), rec_path,
              pixel_size=eff_px)
    meta["rec_done"] = np.array([1])
    summary["tomogram"] = rec_path
    if params.get("tomo_rec_generate_halves"):
        # even/odd-tilt half tomograms beside the reconstruction
        h1, h2 = tomo.wbp_reconstruct_halves(
            t2, angles, shifts=shifts_r, thickness=thickness, slab=slab,
            device=dev)
        for tag, h in (("half1", h1), ("half2", h2)):
            mrc.write(h.cpu().numpy().astype(rec_dtype),
                      f"{work_dir}/{name}.rec_{tag}.mrc", pixel_size=eff_px)
        summary["tomogram_halves"] = True
    method_dn = _denoise_method(params)
    if method_dn != "none":
        with Timer(f"tomogram denoising ({method_dn})"):
            if method_dn == "deconv":
                # Wiener CTF deconvolution at the series' mean defocus
                den = tomo.ctf_deconvolve(
                    recon, float(np.mean(np.asarray(meta["ctf"])[:, :2])),
                    eff_px, voltage_kv=float(params["scope_voltage"]),
                    cs_mm=float(params["scope_cs"]),
                    w=float(params["scope_wgh"]),
                    snr_falloff=float(params.get("denoise_deconv_snr") or 1.0),
                    deconv_strength=float(
                        params.get("denoise_deconv_strength") or 1.0),
                    highpass_nyquist=float(
                        params.get("denoise_deconv_highpass") or 0.02),
                    phase_flipped=bool(params.get("tomo_rec_ctf_correct")),
                    device=dev)
            elif method_dn in ("n2n", "wedge"):
                den = _denoise_trained(method_dn, t2, angles, recon, params,
                                       shifts_r, thickness, slab, dev)
            else:  # bm4d, nad, imod-nad
                from pyp_tpu_torch.ops.denoise_classic import denoise_map

                den = denoise_map(
                    recon, method=method_dn,
                    patch_size=int(params.get("denoise_patch_size") or 4),
                    nsearch=int(params.get("denoise_nsearch") or 11),
                    sigma=float(params.get("denoise_sigma") or 0.25),
                    iters=int(params.get("denoise_iters") or 1), device=dev)
            lp_a = float(params.get("denoise_lowpass") or 0.0)
            if lp_a > 0:
                from pyp_tpu_torch.core.filters import lowpass_filter_3d

                den = lowpass_filter_3d(den, eff_px, lp_a)
            den_path = f"{work_dir}/{name}.den.mrc"
            mrc.write(den.cpu().numpy().astype(np.float32), den_path,
                      pixel_size=eff_px)
            summary["denoised"] = den_path
    return recon if rec_dtype == np.float32 else None


def _denoise_trained(method, t2, angles, recon, params, shifts_r, thickness,
                     slab, dev):
    """The trained tomogram denoisers: n2n learns on the series' own
    even/odd-tilt half tomograms and denoises every slice; wedge learns
    to fill the missing wedge of the tomogram's (z, x) slices and
    restores it."""
    from pyp_tpu_torch.models import denoise as dn
    from pyp_tpu_torch.ops import tomo

    steps = int(params.get("denoise_epochs") or 60)
    lr = float(params.get("denoise_lr") or 1e-3)
    batch = int(params.get("denoise_batch") or 16)
    seed = int(params.get("denoise_seed") or 0)
    if method == "n2n":
        h1, h2 = tomo.wbp_reconstruct_halves(
            t2, angles, shifts=shifts_r, thickness=thickness, slab=slab,
            device=dev)
        model = dn.train_denoiser(
            [h1.cpu().numpy()], [h2.cpu().numpy()], steps=steps, lr=lr,
            lr_finish=float(params.get("denoise_lr_finish") or 0.0),
            batch=batch, seed=seed,
            patch=min(int(params.get("denoise_patch") or 64), thickness,
                      int(t2.shape[-1])), device=dev)
        return dn.denoise_tomogram(model, recon, device=dev)
    model = dn.train_wedge_restorer(
        [recon.cpu().numpy()], tilt_max_deg=float(np.abs(angles).max()),
        steps=steps, lr=lr, batch=batch, seed=seed, patch=min(32, thickness),
        device=dev)
    return dn.restore_wedge(model, recon, device=dev)


def process_tilt_series(item, params: dict, work_dir=".", device="cuda") -> dict:
    """`item`: {"name", "tilts": (T, ny, nx) array or tensor, or "path",
    "angles": (T,)}. Runs every stage the bundle does not have yet on
    `device`; returns a summary dict."""
    from pyp_tpu_torch.core.fft import bin_images
    from pyp_tpu_torch.pipeline.spr import _upload

    dev = resolve_device(device)
    name = item["name"]
    meta = ItemMetadata(name, work_dir, mode="tomo").load()
    meta.refresh(params)
    pixel = float(params["scope_pixel"])
    summary = {"name": name}

    # a series whose alignment, CTF and tomogram are all in the bundle
    # does not read its tilts again
    rec_todo = not meta.is_done("rec_done") or params.get("tomo_rec_force")
    need = (not meta.is_done("ctf") or rec_todo
            or (not meta.is_done("xf")
                and params.get("tomo_ali_method") != "skip"))
    tilts = item.get("tilts")
    if need:
        if tilts is None:
            tilts = mrc.read(item["path"])
        tilts = _upload(tilts, dev)          # the one host->device copy
        shape = tuple(tilts.shape)
    elif tilts is not None:
        shape = tuple(tilts.shape)
    else:
        hdr = mrc.read_header(item["path"])
        shape = (hdr.nz, hdr.ny, hdr.nx)
    angles = np.asarray(item["angles"], dtype=np.float32)
    tiltoff = float(params.get("tomo_ali_tiltoff") or 0.0)
    if tiltoff:
        # constant stage-angle offset applied before alignment
        angles = angles + tiltoff
        summary["tilt_offset_deg"] = tiltoff

    excl = _exclusions(item, meta, params, angles, tilts if need else None,
                       name)
    if excl:
        keep = np.setdiff1d(np.arange(len(angles)), np.asarray(excl, dtype=int))
        if need:
            tilts = tilts[torch.as_tensor(keep, device=dev)]
        angles = angles[keep]
        for k in ("doses", "order"):
            if item.get(k) is not None:
                item[k] = np.asarray(item[k])[keep]
        meta["exclude"] = np.asarray(excl, dtype=np.int64)
        summary["excluded_tilts"] = list(map(int, excl))
    meta["tlt"] = angles

    if params.get("tomo_ali_square") and shape[-2] != shape[-1]:
        # pad rectangular detectors to square (etomo square role)
        side = max(shape[-2:])
        py, px = side - shape[-2], side - shape[-1]
        if need:
            tilts = torch.nn.functional.pad(
                tilts, (px // 2, px - px // 2, py // 2, py - py // 2),
                mode="reflect")
        shape = shape[:-2] + (side, side)
        summary["squared_to"] = side
    binning = int(params.get("tomo_ali_bin") or 4)
    binning = max(1, min(binning, shape[-1] // 128 or 1))
    tilts_b = None
    if need:
        tilts_b = bin_images(tilts, binning) if binning > 1 else tilts
    pixel_b = pixel * binning

    _align(tilts_b, angles, params, meta, summary, item, name, binning,
           pixel_b, dev)
    if meta.is_done("xf"):
        summary["axis_angle"] = float(meta["xf"][0, 2])

    if not meta.is_done("ctf"):
        _fit_ctf(tilts, params, pixel, meta)
    summary["mean_defocus"] = float(np.mean(meta["ctf"][:, :2]))
    del tilts

    rec_bin = int(params.get("tomo_rec_binning") or 8)
    rec_bin = max(1, rec_bin // binning)
    thickness = max(32, int(params.get("tomo_rec_thickness") or 2048) // (binning * rec_bin))
    eff_px = pixel * binning * rec_bin
    recon = None
    if rec_todo:
        with Timer("tomogram reconstruction"):
            t2 = bin_images(tilts_b, rec_bin) if rec_bin > 1 else tilts_b
            recon = _reconstruct(t2, angles, item, params, meta, summary,
                                 work_dir, name, pixel, binning, rec_bin,
                                 thickness, dev)
            del t2
    del tilts_b

    def tomogram():
        # this call's tomogram where it was written as is, else the file
        return recon if recon is not None else as_f32(
            mrc.read(f"{work_dir}/{name}.rec.mrc"), dev)

    if params.get("tomo_seg_open"):
        # open-membrane segmentation (MemBrain-Seg role, sheet half)
        with Timer("membrane segmentation"):
            from pyp_tpu_torch.ops.filament import segment_membranes

            mask_vol, _S, _normals = segment_membranes(
                tomogram(),
                thickness_px=float(params.get("tomo_seg_thickness") or 30.0)
                / eff_px,
                threshold=float(params.get("tomo_seg_thresh") or 0.3),
                device=dev)
            seg_path = f"{work_dir}/{name}.seg.mrc"
            mrc.write(mask_vol.astype(np.float32), seg_path, pixel_size=eff_px)
            summary["segmentation"] = seg_path
            summary["membrane_fraction"] = round(float(mask_vol.mean()), 5)

    method = params.get("tomo_spk_method", "none")
    if not meta.is_done("box") and method == "import" and params.get(
            "tomo_pick_files"):
        _import_picks(params, meta, summary, name)
    elif not meta.is_done("box") and method in ("auto", "surface",
                                                "template", "filament"):
        with Timer("3D particle picking"):
            pick_vol = tomogram()
            if params.get("tomo_mem_use_denoised") and summary.get("denoised"):
                # pick on the denoised tomogram
                pick_vol = as_f32(mrc.read(summary["denoised"]), dev)
            box, vir, spk_eulers = pick_particles_3d(pick_vol, params, eff_px,
                                                     device=dev)
            meta["box"] = box
            if spk_eulers is not None:
                # surface-normal orientation priors for CSPT init
                meta["spk_eulers"] = spk_eulers
            if vir is not None:
                meta["vir"] = vir
                summary["virions"] = len(vir)
            summary["particles"] = len(box)

    if meta.is_done("box"):
        # a resumed series reports its picks too (the JAX package's
        # summary counts only the picks of this call)
        summary["particles"] = int(len(meta["box"]))

    if params.get("plot_per_item", True):
        # per-series diagnostics sheet: a png the report embeds
        try:
            from pyp_tpu_torch.analysis.plots import plot_tilt_series_panel

            plot_tilt_series_panel(
                meta["tlt"], meta["xf"] if meta.is_done("xf") else None,
                meta["ctf"] if meta.is_done("ctf") else None,
                f"{work_dir}/{name}_tilts.png")
        except (ImportError, OSError, ValueError, KeyError) as e:
            logger.warning("per-series plot skipped: %s", e)

    meta.scalars.update({"pixel": pixel, "binning": binning * rec_bin})
    meta.save()
    return summary


def _import_picks(params, meta, summary, name):
    """Coordinate import (<dir>/<name>.{spk,box,mod,cbox,next}, optional
    z flip) into meta["box"]."""
    from pyp_tpu_torch.io import boxfiles

    with Timer("3D pick import"):
        base = Path(str(params["tomo_pick_files"]))
        rows = None
        for ext in (".spk", ".box", ".mod", ".cbox", ".next"):
            cand = (base / f"{name}{ext}") if base.is_dir() else base
            if cand.exists() and str(cand).endswith(ext):
                rows = np.asarray(boxfiles.read_coords(str(cand)),
                                  dtype=np.float32)
                break
        if rows is not None and len(rows):
            coords3 = rows[:, :3]
            if params.get("tomo_pick_files_flip"):
                nz = float(params.get("tomo_rec_thickness")
                           or coords3[:, 0].max() + 1)
                coords3 = coords3.copy()
                coords3[:, 0] = nz - coords3[:, 0]
            box4 = np.concatenate(
                [coords3, np.ones((len(coords3), 1), np.float32)], 1)
            meta["box"] = box4
            summary["particles"] = len(box4)
        else:
            logger.warning("tomo_pick import: no coordinate file for "
                           "%s under %s", name, base)


def _gaussian_filter_3d(vol, sigma: float):
    """scipy.ndimage.gaussian_filter (mode "reflect", truncate 4) of a
    volume tensor: a separable 1-D pass per axis over half-sample
    symmetric padding."""
    r = int(4.0 * sigma + 0.5)
    x = np.arange(-r, r + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k = torch.as_tensor((k / k.sum()).astype(np.float32), device=vol.device)
    out = vol
    for ax in range(3):
        n = out.shape[ax]
        idx = np.arange(-r, n + r)
        idx = np.where(idx < 0, -idx - 1, idx)
        idx = np.where(idx >= n, 2 * n - idx - 1, idx) % max(n, 1)
        padded = torch.index_select(out, ax, torch.as_tensor(idx, device=vol.device))
        moved = padded.movedim(ax, -1)
        shape = moved.shape
        conv = torch.nn.functional.conv1d(moved.reshape(-1, 1, shape[-1]),
                                          k[None, None])
        out = conv.reshape(shape[:-1] + (n,)).movedim(-1, ax)
    return out


def pick_particles_3d(recon, params: dict, eff_pixel: float, device="cuda"):
    """3D picking on a reconstructed tomogram (tomo_spk_method):

    * "auto": per-slab intensity picking;
    * "surface": sphere detection -> spherical-harmonics membrane
      refinement -> surface points as picks, normals as euler priors;
    * "template": exhaustive 3D template matching against a reference map;
    * "filament": vesselness tracing, tangents as euler priors.

    Returns numpy (box (N, 4) rows (z, y, x, score), vir (V, 5) rows
    (z, y, x, radius_px, score) or None, eulers (N, 3) or None)."""
    dev = resolve_device(device)
    method = params.get("tomo_spk_method", "auto")
    rad_px = max(2, int(float(params["tomo_spk_rad"]) / eff_pixel))
    recon = as_f32(recon, dev)
    coords = []
    euler_rows = []
    vir = None

    if method == "surface":
        vir, coords, euler_rows = _pick_surface(recon, params, eff_pixel,
                                                rad_px, dev)
    elif method == "filament":
        from pyp_tpu_torch.ops.filament import pick_filaments

        spacing = float(params.get("tomo_spk_fil_spacing") or 0.0)
        spacing_px = (spacing / eff_pixel) if spacing > 0 else 2.0 * rad_px
        fil_coords, fil_eulers, _fil_id = pick_filaments(
            recon, radius_px=float(rad_px), spacing_px=float(spacing_px),
            threshold=float(params.get("tomo_spk_fil_thresh") or 0.3),
            max_points=int(params.get("tomo_spk_max") or 200) * 20,
            min_points=int(params.get("tomo_spk_fil_min_points") or 4),
            device=dev)
        coords = [tuple(c) for c in fil_coords]
        euler_rows = [tuple(e) for e in fil_eulers]
    elif method == "template":
        coords = _pick_template(recon, params, eff_pixel, rad_px, dev)
    else:  # "auto": slab-wise intensity picking
        coords = _pick_slabs(recon, params, rad_px, dev)
    box = np.asarray(coords, dtype=np.float32).reshape(-1, 4)
    # min-distance NMS across all picks (slab picking produces
    # near-duplicates at adjacent z); surface points are a mesh, not
    # duplicates — NMS there only when asked for
    dist_px = float(params.get("tomo_spk_dist") or 0.0) / eff_pixel
    rt = float(params.get("tomo_pick_radiustimes_3d") or 0.0)
    if dist_px <= 0 and rt > 0:
        dist_px = rt * rad_px          # tomo_pick radiustimes_3d card
    if dist_px <= 0 and method == "auto":
        dist_px = 2.0 * rad_px
    eulers = (np.asarray(euler_rows, dtype=np.float32)
              if euler_rows else None)
    if len(box) > 1 and dist_px > 0:
        from pyp_tpu_torch.analysis.scores import remove_duplicates

        keep = remove_duplicates(box[:, :3], box[:, 3], dist_px)
        box = box[keep]
        if eulers is not None:
            eulers = eulers[keep]
    return box, vir, eulers


def _virions_nn(recon, radii, n_peaks, params, dev):
    """Virion seeds from the membrane network's probability map: the
    weights of -tomo_mem_model / -tomo_vir_nn_model / membrane_model.npz
    (in the working directory), else a network trained on procedural
    membranes and saved there."""
    from pyp_tpu_torch.models import io as mio
    from pyp_tpu_torch.models import membrane as mem

    mpath = Path(str(params.get("tomo_mem_model") or "")
                 or str(params.get("tomo_vir_nn_model") or "")
                 or "membrane_model.npz")
    feats = (16, 32, 64)
    if mpath.exists():
        like = mem.train_membrane_segmenter(steps=0, features=feats,
                                            device=dev)
        loaded, _meta = mio.load_params(mpath, like.params)
        model = mem.MembraneModel(params=loaded, features=feats)
    else:
        with Timer("membrane training"):
            model = mem.train_membrane_segmenter(
                steps=int(params.get("tomo_vir_nn_steps") or 400),
                seed=int(params.get("train_seed") or 0),
                patch=int(params.get("tomo_mem_patch_pxl") or 96),
                features=feats, device=dev)
        mio.save_params(model.params, mpath)
    with Timer("membrane segmentation"):
        prob = mem.segment_tomogram(model, recon, device=dev)
    seg_thres = float(params.get("tomo_mem_seg_thres") or 0.0)
    if seg_thres > 0:
        # probability floor: weak responses don't vote
        prob = torch.where(prob >= seg_thres, prob, torch.zeros_like(prob))
    if params.get("tomo_mem_store_probabilities"):
        mrc.write(prob.cpu().numpy().astype(np.float32), "membrane_prob.mrc")
    return mem.detect_virions_from_segmentation(prob, radii, n_peaks=n_peaks,
                                                device=dev)


def _pick_surface(recon, params, eff_pixel, rad_px, dev):
    from pyp_tpu_torch.core.geometry import normal_to_euler
    from pyp_tpu_torch.ops import template_match as tm

    vir_rad_px = max(4.0, float(params.get("tomo_vir_rad") or 0)
                     / eff_pixel or 3.0 * rad_px)
    radii = np.linspace(0.75 * vir_rad_px, 1.25 * vir_rad_px, 5)
    # detection band: lowpass before the sphere detection so the edge map
    # sees the membrane, not high-frequency noise
    det_vol = recon
    band_a = float(params.get("tomo_vir_detect_band") or 0.0)
    if band_a > 0:
        from pyp_tpu_torch.core.filters import lowpass_filter_3d

        det_vol = lowpass_filter_3d(recon, eff_pixel, band_a)
    det_tol_px = (float(params.get("tomo_vir_det_tol") or 0.0)
                  / eff_pixel) or None
    vbin = int(params.get("tomo_vir_binn") or 1)
    if vbin > 1:
        # detection on a Fourier-binned volume, seeds scaled back up
        from pyp_tpu_torch.core.fft import fourier_crop_3d

        small = tuple(max(16, d // vbin) for d in det_vol.shape)
        det_vol = fourier_crop_3d(det_vol, out_shape=small)
        radii = radii / vbin
        if det_tol_px:
            det_tol_px /= vbin
    vir_method = str(params.get("tomo_vir_method") or "none")
    n_peaks = int(params.get("tomo_vir_detect_max") or 8)
    if vir_method == "nn":
        # the membrane network segments the tomogram itself (it was trained
        # on raw-contrast slices, so no detection band), and the sphere
        # detector votes on its probability map; with -tomo_vir_binn the
        # radii are the binned ones and the seeds are scaled up below, as
        # in the JAX package
        centers, rads, scores, valid = _virions_nn(recon, radii, n_peaks,
                                                   params, dev)
    else:
        detect = (tm.detect_spheres_template if vir_method == "template"
                  else tm.detect_spheres)
        centers, rads, scores, valid = detect(
            det_vol, radii, n_peaks=n_peaks, min_distance=det_tol_px,
            device=dev)
    centers = centers.cpu().numpy()
    rads, scores = rads.cpu().numpy(), scores.cpu().numpy()
    if vbin > 1:
        centers = centers * float(vbin)
        rads = rads * float(vbin)
    vir_rows, coords, euler_rows = [], [], []
    n_pts = int(params.get("tomo_vir_points") or 200)
    margin = 2.0
    shape = np.asarray(recon.shape)
    for c, r, s, v in zip(centers, rads, scores, valid.cpu().numpy()):
        if not v:
            continue
        # skip seeds whose search shell leaves the volume
        if np.any(c - 1.3 * r < margin) or np.any(c + 1.3 * r > shape - margin):
            continue
        search_band = float(params.get("tomo_vir_search_band") or 0.3)
        tol_px = float(params.get("tomo_sphere_seg_tol_px") or 0.0)
        if tol_px > 0:  # band given in px
            search_band = min(0.6, tol_px / max(float(r), 1.0))
        pts, normals, rr = tm.refine_surface_sh(
            recon, c, float(r), n_points=n_pts,
            l_max=int(params.get("tomo_vir_lmax") or 4),
            iters=int(params.get("tomo_vir_sh_iters") or 80),
            lr=float(params.get("tomo_vir_sh_lr") or 0.3),
            smoothness=float(params.get("tomo_vir_sh_smoothness") or 0.05),
            search=search_band,
            n_radial=int(params.get("tomo_vir_radial_samples") or 31),
            device=dev)
        off_px = float(params.get("tomo_srf_offset") or 0.0) / eff_pixel
        if off_px:
            # spikes sit a protein length above the membrane
            pts = pts + off_px * np.asarray(normals)
        vir_rows.append((*c, float(np.mean(rr)), float(s)))
        # surface-normal orientation priors: spikes sit perpendicular to
        # the membrane; normals are (z, y, x)
        nrm = np.asarray(normals)
        phi_n, theta_n, psi_n = normal_to_euler(nrm[:, 2], nrm[:, 1],
                                                nrm[:, 0])
        for p, ph, th, ps in zip(pts, phi_n.numpy(), theta_n.numpy(),
                                 psi_n.numpy()):
            coords.append((p[0], p[1], p[2], float(s)))
            euler_rows.append((float(ph), float(th), float(ps)))
    vir = np.asarray(vir_rows, dtype=np.float32).reshape(-1, 5)
    return vir, coords, euler_rows


def _pick_template(recon, params, eff_pixel, rad_px, dev):
    from pyp_tpu_torch.ops import template_match as tm
    from pyp_tpu_torch.ops.refine3d import make_directions

    ref_path = params.get("tomo_pick_ref") or ""
    if not ref_path:
        raise ValueError(
            "tomo_spk_method=template requires -tomo_pick_ref <map.mrc>")
    template = _prepare_pick_template(mrc.read(ref_path), params, eff_pixel,
                                      device=dev)
    # tomogram conditioning (pytom low/high pass + whitening roles)
    vol = recon
    lp = float(params.get("tomo_pick_low_pass") or 0.0)
    hp = float(params.get("tomo_pick_high_pass") or 0.0)
    if lp > 0 or hp > 0:
        from pyp_tpu_torch.core.filters import apply_bandpass

        lo_frac = (eff_pixel / hp) if hp > 0 else 0.0
        hi_frac = (eff_pixel / lp) if lp > 0 else 0.5
        vol = apply_bandpass(vol, lo_frac, hi_frac)   # per-slab 2D bandpass
    if params.get("tomo_pick_spectral_whitening"):
        vol = _whiten_volume(vol, device=dev)
    step = float(params.get("tomo_pick_ang") or 30.0)
    dirs = make_directions(step, params.get("particle_sym", "C1"))
    psis = np.arange(0.0, 360.0, step, dtype=np.float32)
    angles = np.array([(d[0], d[1], p) for d in dirs for p in psis],
                      dtype=np.float32)
    score, _ = tm.match_template_3d(vol, template, angles, device=dev)
    if params.get("tomo_pick_random_phase_correction"):
        # background from a phase-randomized template at one rotation: the
        # same spectrum without structure scores the match's noise floor
        rng_t = np.random.RandomState(0)
        Ft = np.fft.rfftn(np.asarray(template))
        Ft = np.abs(Ft) * np.exp(1j * rng_t.uniform(0, 2 * np.pi, Ft.shape))
        t_rand = np.fft.irfftn(Ft, s=template.shape,
                               axes=(0, 1, 2)).astype(np.float32)
        bg, _ = tm.match_template_3d(vol, t_rand, np.zeros((1, 3), np.float32),
                                     device=dev)
        score = score - bg
    thresh = float(params.get("tomo_spk_thresh") or 0.0)
    if params.get("tomo_pick_estimate_cutoff") and not thresh:
        thresh = _score_cutoff_from_fp(
            score, float(params.get("tomo_pick_n_false_positives") or 1.0))
    elif float(params.get("tomo_pick_cutoff") or 0.0) and not thresh:
        thresh = float(params["tomo_pick_cutoff"])
    pk, vals, valid = tm.pick_peaks_3d(
        score, int(params.get("tomo_spk_max") or 200), min_distance=rad_px,
        threshold=thresh)
    valid = valid.cpu().numpy()
    return [(z, y, x, float(s)) for (z, y, x), s in
            zip(pk.cpu().numpy()[valid], vals.cpu().numpy()[valid])]


def _pick_slabs(recon, params, rad_px, dev):
    from pyp_tpu_torch.ops import pick

    det = recon
    if params.get("tomo_pick_gaussian_3d"):
        # pre-smoothing ahead of detection (tomo_pick gaussian_3d /
        # sigma_3d cards)
        det = _gaussian_filter_3d(
            recon, float(params.get("tomo_pick_sigma_3d") or 15.0) / 10.0)
    thr_sig = float(params.get("tomo_pick_stdtimes_filt_3d") or 0.0) \
        or float(params.get("tomo_spk_slab_thresh") or 4.0)
    edge = 2 * rad_px if params.get("tomo_pick_remove_edge_3d") else rad_px
    rows = []
    for z in range(det.shape[0]):
        res = pick.pick_particles(
            det[z], particle_radius_px=rad_px,
            max_picks=int(params.get("tomo_spk_slab_max") or 64),
            threshold_sigma=thr_sig, edge_px=edge, invert=False, device=dev)
        rows.append(torch.cat([torch.full_like(res.scores, z)[:, None],
                               res.coords.to(torch.float32),
                               res.scores[:, None],
                               res.valid.to(torch.float32)[:, None]], 1))
    if not rows:
        return []
    rows = torch.cat(rows).cpu().numpy()      # one read of every slab's picks
    rows = rows[rows[:, 4] > 0]
    return [(int(z), y, x, s) for z, y, x, s, _ in rows]


def tomo_merge(results: dict, missing: list, work_dir=".") -> dict:
    ok = [r for r in results.values() if r]
    out = {
        "tilt_series": len(ok),
        "missing": list(missing),
        "particles": int(sum(r.get("particles", 0) for r in ok)),
    }
    logger.info("merged %d tilt-series (%d missing)", len(ok), len(missing))
    return out


def _prepare_pick_template(template, params, eff_pixel: float, device="cuda"):
    """Template conditioning for 3D matching (the pytom_* template cards):
    optional resize to tomo_pick_template_size, contrast inversion,
    mirror, and masking (auto sphere / gaussian / file). Returns numpy."""
    from pyp_tpu_torch.core.fft import fourier_crop_3d
    from pyp_tpu_torch.core.filters import soft_spherical_mask

    dev = resolve_device(device)
    t = np.asarray(template, dtype=np.float32)
    size = int(params.get("tomo_pick_template_size") or 0)
    if size and size != t.shape[-1]:
        t = fourier_crop_3d(as_f32(t, dev), out_shape=(size, size, size)
                            ).cpu().numpy().astype(np.float32)
    if params.get("tomo_pick_template_invert"):
        t = -t
    if params.get("tomo_pick_template_mirror"):
        t = t[::-1].copy()
    mm = str(params.get("tomo_pick_mask_method") or "auto")
    n_t = t.shape[-1]
    if mm == "file" and params.get("tomo_pick_mask_file"):
        t = t * np.asarray(mrc.read(str(params["tomo_pick_mask_file"])),
                           dtype=np.float32)
    elif mm == "gaussian":
        sig = float(params.get("tomo_pick_mask_sigma") or 1.0) * n_t / 6.0
        ax = np.arange(n_t) - n_t // 2
        g = np.exp(-0.5 * (ax / max(sig, 1e-3)) ** 2).astype(np.float32)
        t = t * g[:, None, None] * g[None, :, None] * g[None, None, :]
    elif mm == "auto":
        t = t * soft_spherical_mask(n_t, n_t * 0.45, 3.0).numpy()
    return t


def _whiten_volume(vol, device="cuda"):
    """Spectral whitening: divide the volume's Fourier coefficients by the
    radial amplitude profile in nx//2 shells (pytom_spectral_whitening
    role). The shells are those of the volume's own rfft grid: on a cube
    they are the JAX package's, which handles cubes only. Returns a
    tensor on `device`."""
    dev = resolve_device(device)
    v = as_f32(vol, dev)
    nz, ny, nx = v.shape
    F = torch.fft.rfftn(v)
    n_bins = nx // 2
    r = np.sqrt(np.fft.fftfreq(nz)[:, None, None] ** 2
                + np.fft.fftfreq(ny)[None, :, None] ** 2
                + np.fft.rfftfreq(nx)[None, None, :] ** 2)
    bins = np.clip((r / 0.5 * n_bins).astype(np.int32), 0, n_bins - 1)
    bins = torch.as_tensor(bins.reshape(-1).astype(np.int64), device=dev)
    amp2 = torch.zeros(n_bins, device=dev).index_add_(
        0, bins, F.abs().reshape(-1) ** 2)
    cnt = torch.zeros(n_bins, device=dev).index_add_(
        0, bins, torch.ones(bins.numel(), device=dev))
    prof = torch.sqrt(torch.clamp(amp2 / torch.clamp(cnt, min=1.0), min=1e-12))
    w = (1.0 / prof)[bins].reshape(F.shape)
    return torch.fft.irfftn(F * w, s=v.shape)


def _score_cutoff_from_fp(score_map, n_false_positives: float):
    """Threshold from a Gaussian background model: the value whose
    upper-tail expectation over the search volume equals the allowed
    false-positive count (pytom_estimate_cutoff role)."""
    s = score_map.reshape(-1).to(torch.float32)
    mu, sd = float(s.mean()), float(s.std(correction=0) + 1e-9)
    n_vox = s.numel()
    # P(X > mu + k sd) = erfc(k/sqrt(2))/2 = n_fp / n_vox
    target = max(float(n_false_positives), 1e-3) / n_vox
    # invert erfc by bisection (k in [0, 8])
    lo, hi = 0.0, 8.0
    for _ in range(60):
        k = 0.5 * (lo + hi)
        if 0.5 * math.erfc(k / math.sqrt(2.0)) > target:
            lo = k
        else:
            hi = k
    return mu + 0.5 * (lo + hi) * sd
