"""Single-particle (SPA) preprocessing pipeline — the torch port of
pyp_tpu/pipeline/spr.py.

Per micrograph — frame alignment, CTF estimation, particle picking,
extraction bookkeeping — with metadata-driven `is_done` resume and a merge
step that assembles the dataset-level summary. The `<name>.meta.npz`
bundles are the JAX package's, so either package resumes from the other's.

The movie is uploaded to the device once; gain and defect correction,
magnification correction, hot-pixel removal, frame grouping, alignment,
averaging, the periodogram, the CTF search and the picking all run there,
and only what the bundle stores comes back to the host.

With `-denoise_spr n2n` a noise2noise U-Net (`models.denoise`), trained
on the first micrograph's even/odd frame averages and kept for the
process, denoises the average that picking reads (CTF and extraction
stay on the raw average); `-detect_method nn` picks with the learned
picker (`models.picker`) whose weights `sprtrain` writes to
picker_model.npz (or -detect_nn_model).
"""

from __future__ import annotations

import threading
from pathlib import Path

import numpy as np
import torch

from pyp_tpu_torch import as_f32, resolve_device
from pyp_tpu_torch.io import cistem, mrc
from pyp_tpu_torch.io.metadata import ItemMetadata
from pyp_tpu_torch.utils import Timer, get_logger

logger = get_logger("spr")

# the noise2noise micrograph denoiser, one per process as in the JAX
# package: the first micrograph trains it, the rest reuse it. The lock
# makes executor threads (slurm_tasks > 1) wait for the one that trains,
# where the JAX package's threads may each train a model.
_spr_denoiser_cache: dict = {}
_spr_denoiser_lock = threading.Lock()


def load_movie(path, params=None, dtype=np.float32):
    """Read a movie stack into a (n_frames, ny, nx) numpy array of `dtype`
    (None keeps the file's own type, e.g. int8 counts). Dispatches every
    camera format the io layer decodes — MRC, TIFF, EER, DM3/DM4 —
    including bz2/gz compressed variants."""
    path = str(path)
    params = params or {}
    if path.endswith((".bz2", ".gz")):
        import bz2
        import gzip
        import tempfile

        opener = bz2.open if path.endswith(".bz2") else gzip.open
        inner = path.rsplit(".", 1)[0]
        suffix = "." + inner.rsplit(".", 1)[-1]
        with opener(path, "rb") as f, tempfile.NamedTemporaryFile(
                suffix=suffix) as tmp:
            tmp.write(f.read())
            tmp.flush()
            return load_movie(tmp.name, params, dtype)
    if path.endswith((".tif", ".tiff")):
        from pyp_tpu_torch.io.tiff import read as tiff_read

        data = np.asarray(tiff_read(path))
    elif path.endswith(".eer"):
        from pyp_tpu_torch.io import eer

        data = eer.read(
            path, frame_groups=int(params.get("movie_eer_frames") or 40),
            upsampling=int(params.get("data_eer_upsampling") or 1))
    elif path.endswith((".dm3", ".dm4")):
        from pyp_tpu_torch.io import dm

        data = np.asarray(dm.read(path))
    else:
        data = mrc.read(path)
    if data.ndim == 2:
        data = data[None]
    return data if dtype is None else data.astype(dtype, copy=False)


def _upload(frames, dev):
    """Frames (numpy, in the file's own type, or a tensor) as a float32
    tensor on `dev`: one host->device copy, the conversion on the device."""
    if not isinstance(frames, torch.Tensor):
        frames = np.ascontiguousarray(frames)
        if frames.dtype.byteorder not in "=|" or frames.dtype == np.uint16:
            frames = frames.astype(np.float32)
        frames = torch.from_numpy(frames)
    return frames.to(dev).to(torch.float32)


def apply_gain(frames, params):
    """Flip, defect and gain correction of a (n_frames, ny, nx) float32
    tensor, on its device."""
    from pyp_tpu_torch.ops.pick import median

    dev = frames.device
    if params.get("data_flipy"):
        frames = torch.flip(frames, dims=(1,))
    defects = str(params.get("gain_defects_file") or "")
    if defects:
        # camera defect list: rows "x y [w h]" (SerialEM/IMOD defect text);
        # defect pixels are unusable counts — replace with the per-frame
        # median so they neither bias the gain nor trip the hot-pixel pass
        med = median(frames.reshape(frames.shape[0], -1), dim=1)
        frames = frames.clone()
        with open(defects) as f:
            for line in f:
                row = line.split()
                if not row or row[0].startswith("#"):
                    continue
                x, y = int(float(row[0])), int(float(row[1]))
                w = int(float(row[2])) if len(row) > 2 else 1
                h = int(float(row[3])) if len(row) > 3 else 1
                frames[:, y:y + h, x:x + w] = med[:, None, None]
    gain_path = params.get("gain_reference") or ""
    if not gain_path:
        return frames
    gain = as_f32(mrc.read(gain_path), dev)
    if gain.ndim == 3:
        gain = gain[0]
    rot = int(params.get("gain_rotation") or 0)
    if rot:
        gain = torch.rot90(gain, rot)
    if params.get("gain_fliph"):
        gain = torch.flip(gain, dims=(1,))
    if params.get("gain_flipv"):
        gain = torch.flip(gain, dims=(0,))
    frames = frames * gain[None]
    if params.get("movie_force_integer"):
        # counting cameras: round gain-corrected values back to integer
        # counts (reference movie tab force_integer)
        frames = torch.round(frames)
    return frames


def _prepare_frames(item, params, dev):
    """The movie of `item` on `dev`, corrected and cut as the parameters
    say: gain, magnification correction, hot pixels, frame range,
    grouping, contrast."""
    from pyp_tpu_torch.ops.motion import correct_mag_distortion
    from pyp_tpu_torch.ops.pick import remove_hot_pixels

    raw = item.get("frames")
    if raw is None:
        raw = load_movie(item["path"], params, dtype=None)
    frames = apply_gain(_upload(raw, dev), params)
    del raw
    if params.get("movie_magcorr"):
        # anisotropic-magnification correction ahead of alignment
        # (movie tab magcorr; scope mag_major/minor/distort_ang)
        frames = correct_mag_distortion(
            frames,
            float(params.get("scope_mag_major") or 1.0),
            float(params.get("scope_mag_minor") or 1.0),
            float(params.get("scope_distort_ang") or 0.0))
    if params.get("data_remove_xrays", True):
        frames = remove_hot_pixels(
            frames, sigmas=float(params.get("data_hot_sigma") or 8.0))
    first = int(params.get("movie_first") or 0)
    last = int(params.get("movie_last") or -1)
    if last < 0:
        last = frames.shape[0]
    frames = frames[first:last]
    grp = int(params.get("movie_group") or 1)
    if grp > 1:  # frame grouping (dose fractionation rebinning)
        nf = (frames.shape[0] // grp) * grp
        frames = frames[:nf].reshape(-1, grp, *frames.shape[1:]).mean(1)
    if params.get("data_invert"):
        frames = -frames
    return frames


def _align(f, params, pixel, meta):
    """The alignment branch the parameters select on the frames `f`:
    (MotionResult, average), both on f's device."""
    from pyp_tpu_torch.ops import motion

    dev = f.device
    dose = float(params.get("scope_dose_rate") or 1.0)
    doses = (float(params.get("scope_init_dose") or 0.0)
             + torch.arange(1, f.shape[0] + 1, device=dev) * dose)
    # camera-sized movies (K3: 40x4096^2) take the binned path that
    # FFTs the movie once
    large = f.numel() > int(params.get(
        "movie_large_threshold_mpix") or 300) * 1_000_000
    if large:
        res = motion.align_movie_large(
            f, pixel_size=pixel,
            binning=int(params.get("movie_align_bin") or 2),
            doses=doses,
            dose_weighted=bool(params.get("movie_weights")),
            bfactor=float(params["movie_bfactor"]),
            max_iters=int(params["movie_iters"]),
            smooth_order=int(params["movie_smooth_order"]),
            device=dev,
        )
        return res, res.average
    if int(params.get("movie_patches") or 0) > 1:
        # MotionCor-style local motion: global pass + per-patch residual
        # tracking
        p = int(params["movie_patches"])
        res, patch_shifts, _centers = motion.align_movie_patches(
            f,
            patch_grid=(p, p),
            pixel_size=pixel,
            bfactor=float(params.get("movie_patch_bfactor") or 500.0),
            max_iters=int(params.get("movie_patch_iters") or 6),
            search_radius=float(params["movie_search"]),
            smooth_order=int(params.get("movie_patch_smooth") or 3),
            device=dev,
        )
        meta["patch_shifts"] = patch_shifts.cpu().numpy()
    else:
        res = motion.align_movie(
            f,
            pixel_size=pixel,
            bfactor=float(params["movie_bfactor"]),
            max_iters=int(params["movie_iters"]),
            search_radius=float(params["movie_search"]),
            smooth_order=int(params["movie_smooth_order"]),
            ref=str(params.get("movie_ref") or "average"),
            phase_only=bool(params.get("movie_phase_only")),
            tol=float(params.get("movie_tol") or 0.0),
            device=dev,
        )
    if params.get("movie_weights"):
        return res, motion.dose_weighted_average(f, res.shifts, doses, pixel)
    return res, res.average


def _fit_ctf(average, params, pixel, meta):
    """CTF estimation of the micrograph `average` (a tensor on the
    device) into meta's ctf entries."""
    from pyp_tpu_torch.ops import ctf_fit

    dev = average.device
    scope = dict(voltage_kv=float(params["scope_voltage"]),
                 cs_mm=float(params["scope_cs"]))
    wgh = float(params["scope_wgh"])
    search = dict(
        dfmin=float(params["ctf_min_def"]),
        dfmax=float(params["ctf_max_def"]),
        dfstep=float(params["ctf_fstep"]),
        min_res=float(params["ctf_min_res"]),
        max_res=float(params["ctf_max_res"]),
        amplitude_contrast=wgh, **scope)
    power = ctf_fit.periodogram(
        average,
        tile=min(int(params["ctf_tile"]), min(average.shape)),
        overlap=float(params.get("ctf_tile_overlap") or 0.5),
    )
    # the fit takes the scope's voltage, Cs and amplitude contrast (the
    # JAX pipeline leaves them at the fit's defaults, 300 kV / 2.7 mm /
    # 0.07, which are also the schema's)
    fit = ctf_fit.fit_ctf(
        power, pixel,
        fit_astigmatism=bool(params["ctf_use_ast"]),
        max_astig=float(params["ctf_dast"]),
        fit_phase=bool(params["ctf_use_phs"]),
        phase_min=float(params.get("ctf_phase_min") or 0.0),
        phase_max=float(params.get("ctf_phase_max") or 3.1416),
        phase_steps=int(params.get("ctf_phase_steps") or 14),
        n_g=int(params.get("ctf_polar_rings") or 384),
        n_theta=int(params.get("ctf_polar_angles") or 64),
        lowres_1d=float(params.get("ctf_lowres_1d") or 8.0),
        bg_sigma=float(params.get("ctf_bg_sigma") or 6.0),
        # calibrated-astigmatism pinning (ctf tab known_ast)
        known_astig=(float(params["ctf_known_ast"])
                     if params.get("ctf_known_ast") else None),
        known_astig_angle=float(
            params.get("ctf_known_ast_angle") or 0.0),
        device=dev, **search,
    )
    meta["ctf"] = torch.stack(list(fit)).cpu().numpy().astype(np.float64)
    # CTFFIND-style diagnostics: 1D rotational average table + fitted model
    meta["ctf_avgrot"] = np.stack(ctf_fit.avgrot(
        power, pixel, fit, w=wgh,
        n_bins=int(params.get("ctf_avgrot_bins") or 256), **scope))
    if params.get("ctf_determine_thickness"):
        # sample-thickness node fit (ctffind5 role)
        t, t_cc = ctf_fit.fit_thickness(
            power, pixel, fit, amplitude_contrast=wgh,
            min_res=float(params["ctf_min_res"]),
            max_res=float(params["ctf_max_res"]),
            t_max=float(params.get("ctf_thickness_max") or 1000.0),
            n_steps=int(params.get("ctf_thickness_steps") or 51), **scope)
        meta["ctf_thickness"] = np.array([float(t), float(np.max(t_cc))])
    if params.get("ctf_use_lcl"):
        # per-region fits -> defocus plane for per-particle defocus
        # interpolation at extraction
        g = max(2, int(params.get("ctf_lcl_grid") or 2))
        _fits, plane = ctf_fit.fit_ctf_local(
            average, pixel, grid=(g, g),
            tile=min(int(params["ctf_tile"]) // 2, min(average.shape) // g),
            device=dev, **search)
        meta["ctf_plane"] = np.asarray(plane, dtype=np.float64)
    meta["ctf_diag"] = ctf_fit.diagnostic_image(
        power, pixel, fit, w=wgh,
        size=int(params.get("ctf_diag_size") or 512), **scope)


def _pick(pick_image, params, pixel, meta):
    """Size-based picking on `pick_image` (a tensor on the device) into
    meta["box"]: rows (y, x, score)."""
    from pyp_tpu_torch.ops import pick

    dev = pick_image.device
    radius_px = max(4, int(float(params["detect_rad"]) / pixel))
    if params.get("detect_gold_erase"):
        # gold fiducials outshine particles; erase before picking
        gold_px = max(2, int(float(params.get("detect_gold_rad")
                                   or 50.0) / pixel))
        g = pick.detect_gold_beads(
            pick_image, bead_radius_px=gold_px,
            max_beads=int(params.get("detect_gold_max") or 256),
            threshold_sigma=float(params.get("detect_gold_thresh") or 5.0),
            device=dev)
        pick_image = pick.erase_blobs(pick_image, g.coords, g.valid,
                                      1.5 * gold_px)
    res = pick.pick_particles(
        pick_image,
        particle_radius_px=radius_px,
        max_picks=int(params["detect_max"]),
        min_distance_px=int(float(params["detect_dist"]) or radius_px),
        threshold_sigma=float(params["detect_thresh"]),
        edge_px=int(params.get("detect_edge") or 0)
        or int(params["extract_box"]) // 2,
        invert=bool(params.get("detect_invert", True)),
        mask_contamination=bool(params.get("detect_contamination", True)),
        band_low=float(params.get("detect_band_low") or 6.0),
        band_high=float(params.get("detect_band_high") or 1.5),
        disk_frac=float(params.get("detect_disk_frac") or 0.5),
        cont_sigma=float(params.get("detect_cont_sigma") or 8.0),
        cont_scale=float(params.get("detect_cont_scale") or 4.0),
        device=dev,
    )
    rows = torch.cat([res.coords.to(torch.float32), res.scores[:, None]],
                     dim=1)[res.valid]
    meta["box"] = rows.cpu().numpy().astype(np.float64)


def _denoise_micrograph(frames, average, meta, params, dev):
    """The denoised average (numpy float32): the n2n model, trained on the
    aligned movie's even/odd frame averages where the process has none
    yet, applied to `average`."""
    from pyp_tpu_torch.models import denoise as dn
    from pyp_tpu_torch.ops.motion import _phase_ramp

    f = frames.to(torch.float32)
    F = torch.fft.rfft2(f) * _phase_ramp(as_f32(meta["drift"], dev),
                                         f.shape[1], f.shape[2])
    aligned = torch.fft.irfft2(F, s=f.shape[1:])
    del F
    with _spr_denoiser_lock:
        model = _spr_denoiser_cache.get("model")
        if model is None:
            even = aligned[0::2].mean(dim=0).cpu().numpy()
            odd = aligned[1::2].mean(dim=0).cpu().numpy()
            model = dn.train_denoiser(
                [even], [odd],
                steps=int(params.get("denoise_epochs") or 60),
                lr=float(params.get("denoise_lr") or 1e-3),
                patch=int(params.get("denoise_patch") or 64),
                batch=int(params.get("denoise_batch") or 16),
                seed=int(params.get("denoise_seed") or 0),
                features=(16, 32), device=dev)
            _spr_denoiser_cache["model"] = model
    return dn.denoise_image(model, average, features=(16, 32),
                            device=dev).cpu().numpy().astype(np.float32)


def _pick_nn(pick_image, params, pixel, meta, work_dir):
    """The learned picker on `pick_image` (a tensor on the device) into
    meta["box"]: weights from -detect_nn_model or the project's
    picker_model.npz (what `sprtrain` writes), rows (y, x, score)."""
    from pyp_tpu_torch.models import io as mio
    from pyp_tpu_torch.models import picker as nn_picker
    from pyp_tpu_torch.models.unet import UNet2D

    dev = pick_image.device
    radius_px = max(4, int(float(params["detect_rad"]) / pixel))
    model_path = Path(str(params.get("detect_nn_model") or "")
                      or Path(work_dir) / "picker_model.npz")
    features, patch = (8, 16, 32), 128
    weights, meta_np = mio.load_params(model_path,
                                       UNet2D(features).state_dict())
    model = nn_picker.PickerModel(params=weights,
                                  patch=int(meta_np.get("patch", patch)),
                                  radius_px=radius_px)
    heat = nn_picker.infer_heatmap(model, pick_image, features=features,
                                   device=dev)
    coords, vals, valid = nn_picker.pick_from_heatmap(
        heat, radius_px,
        threshold=float(params.get("detect_nn_threshold") or 0.3),
        max_picks=int(params["detect_max"]), device=dev)
    rows = torch.cat([coords.to(torch.float32), vals[:, None]], dim=1)[valid]
    meta["box"] = rows.cpu().numpy().astype(np.float64)


def process_micrograph(item, params: dict, work_dir=".",
                       device="cuda") -> dict:
    """Full per-micrograph preprocessing on `device`. `item` is
    {"name", "path"} or {"name", "frames": array}. Returns a summary dict
    (with "frame_uploads", the host->device copies of the movie this call
    made); detailed arrays land in the ItemMetadata bundle."""
    dev = resolve_device(device)
    name = item["name"]
    meta = ItemMetadata(name, work_dir, mode="spr").load()
    dropped = meta.refresh(params)
    entries_before = meta.entries()
    pixel = float(params["scope_pixel"]) * int(params.get("data_bin") or 1)
    summary = {"name": name, "frame_uploads": 0}
    if params.get("scope_mag"):
        # nominal magnification: display metadata for the web/db pushes
        summary["mag"] = float(params["scope_mag"])

    frames = None
    average_dev = None  # the average on the device when freshly computed

    def get_frames():
        nonlocal frames
        if frames is None:
            frames = _prepare_frames(item, params, dev)
            summary["frame_uploads"] += 1
        return frames

    # ---- motion correction ------------------------------------------------
    if not meta.is_done("drift") and params.get("movie_ali") != "skip":
        with Timer("movie alignment"):
            res, average_dev = _align(get_frames(), params, pixel, meta)
            meta["drift"] = res.shifts.cpu().numpy()
            meta["average"] = average_dev.cpu().numpy().astype(np.float32)
    elif not meta.is_done("average"):
        f = get_frames()
        meta["drift"] = np.zeros((f.shape[0], 2), dtype=np.float32)
        average_dev = f.mean(dim=0)
        meta["average"] = average_dev.cpu().numpy()
    summary["drift_px"] = float(np.abs(np.diff(meta["drift"], axis=0)).sum())
    method = params.get("detect_method", "auto")
    to_pick = not meta.is_done("box") and method not in ("none", "manual")

    # ---- micrograph denoising (the topaz-denoise/cryoCARE SPR role) ------
    # the denoised average feeds picking only; CTF and extraction stay on
    # the raw average
    denoise = (str(params.get("denoise_spr") or "none") == "n2n"
               and "drift" in meta and meta["drift"].shape[0] >= 4)
    if denoise and not meta.is_done("denoised"):
        with Timer("micrograph denoise"):
            meta["denoised"] = _denoise_micrograph(
                get_frames(), meta["average"], meta, params, dev)
    frames = None
    if denoise:
        summary["denoised"] = True
    if average_dev is None and (to_pick or not meta.is_done("ctf")):
        average_dev = as_f32(meta["average"], dev)  # resumed: from the bundle

    # ---- CTF estimation ---------------------------------------------------
    if not meta.is_done("ctf"):
        with Timer("CTF estimation"):
            _fit_ctf(average_dev, params, pixel, meta)
    ctf_vec = meta["ctf"]
    summary["df1"], summary["df2"] = float(ctf_vec[0]), float(ctf_vec[1])
    summary["ctf_fit_res"] = float(ctf_vec[5])

    # ---- particle picking -------------------------------------------------
    if to_pick:
        pick_image = (as_f32(meta["denoised"], dev) if denoise
                      else average_dev)
        if method == "nn":
            with Timer("NN particle picking"):
                _pick_nn(pick_image, params, pixel, meta, work_dir)
        else:
            with Timer("particle picking"):
                _pick(pick_image, params, pixel, meta)
    summary["particles"] = int(len(meta["box"])) if meta.is_done("box") else 0

    if params.get("plot_per_item", True):
        # per-micrograph diagnostics: pngs the HTML report embeds
        try:
            from types import SimpleNamespace

            from pyp_tpu_torch.analysis import plots as _plots

            if meta.is_done("drift"):
                _plots.plot_drift(meta["drift"],
                                  f"{work_dir}/{name}_drift.png")
            if meta.is_done("ctf_avgrot") and meta.is_done("ctf"):
                g, radial, norm_radial, model = np.asarray(
                    meta["ctf_avgrot"])
                c = np.asarray(meta["ctf"])
                _plots.plot_ctf_fit(
                    g, radial, norm_radial, model,
                    SimpleNamespace(df1=c[0], df2=c[1], angast=c[2],
                                    fit_res=c[5]),
                    f"{work_dir}/{name}_ctf.png")
        except (ImportError, OSError, ValueError, KeyError) as e:
            logger.warning("per-item plots skipped: %s", e)

    scalars = {"pixel": pixel, "voltage": float(params["scope_voltage"])}
    # a resumed item whose bundle is complete and unchanged is not written
    # again (compressing a camera-sized average takes seconds)
    if (dropped or meta.entries() != entries_before
            or any(meta.scalars.get(k) != v for k, v in scalars.items())):
        meta.scalars.update(scalars)
        meta.save()
    return summary


def extract_stack(items, params, work_dir=".", out_stack="stack.mrc",
                  device="cuda"):
    """Dataset-level extraction: windows every picked particle from its
    micrograph average into one stack + a .cistem parameter table. Returns
    (stack numpy (N, box, box), table), or (None, None) with no picks."""
    from pyp_tpu_torch.core.fft import fourier_crop
    from pyp_tpu_torch.ops import extract as ex
    from pyp_tpu_torch.ops.ctf_fit import defocus_at_positions

    dev = resolve_device(device)
    box = int(params["extract_box"])
    # extract_bin: window at box*bin full-res pixels, Fourier-crop to box
    ebin = max(1, int(params.get("extract_bin") or 1))
    pixel = float(params["scope_pixel"]) * int(params.get("data_bin") or 1) * ebin
    all_imgs = []
    rows = []
    film = 0
    for item in items:
        name = item["name"] if isinstance(item, dict) else item
        meta = ItemMetadata(name, work_dir, mode="spr").load()
        if not (meta.is_done("box") and meta.is_done("average")):
            continue
        coords = meta["box"][:, :2].astype(np.float32)
        if len(coords) == 0:
            film += 1
            continue
        stack = ex.extract_particles(
            meta["average"], coords, box * ebin,
            invert=bool(params.get("extract_inv", True)),
            normalize=bool(params.get("extract_norm", True)),
            subpixel=bool(params.get("extract_subpixel", True)),
            device=dev,
        )
        if ebin > 1:
            stack = fourier_crop(stack, (box, box))
        all_imgs.append(stack.cpu().numpy())
        ctf_vec = meta["ctf"] if meta.is_done("ctf") else np.zeros(6)
        if meta.is_done("ctf_plane"):
            # per-particle defocus from the local plane fit (ctf_use_lcl):
            # offset df1/df2 by (plane(y,x) - plane mean defocus)
            d_local = defocus_at_positions(meta["ctf_plane"], coords)
            d_off = d_local - 0.5 * (ctf_vec[0] + ctf_vec[1])
        else:
            d_off = np.zeros(len(coords))
        for c, do in zip(coords, d_off):
            rows.append((film, c[0], c[1], ctf_vec[0] + do, ctf_vec[1] + do,
                         ctf_vec[2]))
        film += 1
    if not all_imgs:
        return None, None
    stack = np.concatenate(all_imgs, axis=0)
    if str(params.get("extract_fmt") or "mrc") == "mrcs" and \
            out_stack.endswith(".mrc"):
        out_stack += "s"  # RELION-style stack naming
    if params.get("extract_float16"):
        stack = stack.astype(np.float16)
    mrc.write(stack, Path(work_dir) / out_stack, pixel_size=pixel)

    n = len(rows)
    table = cistem.Table.zeros(n)
    arr = np.asarray(rows, dtype=np.float64)
    table["position_in_stack"] = np.arange(1, n + 1)
    table["image_is_active"] = np.ones(n)
    table["particle_group"] = arr[:, 0] + 1
    table["original_y_position"] = arr[:, 1]
    table["original_x_position"] = arr[:, 2]
    table["defocus_1"] = arr[:, 3]
    table["defocus_2"] = arr[:, 4]
    table["defocus_angle"] = arr[:, 5]
    table["pixel_size"] = np.full(n, pixel)
    table["microscope_voltage"] = np.full(n, float(params["scope_voltage"]))
    table["microscope_cs"] = np.full(n, float(params["scope_cs"]))
    table["amplitude_contrast"] = np.full(n, float(params["scope_wgh"]))
    table["occupancy"] = np.full(n, 100.0)
    table["assigned_subset"] = np.arange(n) % 2 + 1
    cistem.write_parameters(
        table, Path(work_dir) / Path(out_stack).with_suffix(".cistem"))
    return stack, table


def spr_merge(results: dict, missing: list, work_dir=".") -> dict:
    """Dataset merge: aggregate per-micrograph summaries and report missing
    items."""
    ok = [r for r in results.values() if r]
    out = {
        "micrographs": len(ok),
        "missing": list(missing),
        "particles": int(sum(r.get("particles", 0) for r in ok)),
        "mean_ctf_fit_res": float(np.mean([r["ctf_fit_res"] for r in ok]))
        if ok else 0.0,
    }
    logger.info(
        "merged %d micrographs (%d missing), %d particles",
        out["micrographs"], len(missing), out["particles"],
    )
    from pyp_tpu_torch.stream.web import Web

    web = Web()
    if web.exists:
        for r in ok:
            web.write_micrograph(r["name"], r)
    return out


def estimate_gain(movie_paths, max_movies: int = 10, device="cuda"):
    """Estimate a multiplicative gain reference from raw counting movies
    (the reference's `pypgain` mode): gain = mean(all frames) over
    many movies, normalized to unit mean, inverted — flat-field estimate.
    The frames are summed in float64 on `device`; returns float32 numpy."""
    dev = resolve_device(device)
    acc = None
    count = 0
    for path in list(movie_paths)[:max_movies]:
        frames = _upload(load_movie(path, dtype=None), dev)
        s = frames.sum(dim=0, dtype=torch.float64)
        acc = s if acc is None else acc + s
        count += frames.shape[0]
    if acc is None or count == 0:
        raise ValueError("no movies found for gain estimation")
    mean_img = acc / count
    mean_img = torch.clamp(mean_img, min=1e-6 * float(mean_img.mean()))
    gain = mean_img.mean() / mean_img
    return gain.to(torch.float32).cpu().numpy()
