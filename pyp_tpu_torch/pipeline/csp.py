"""CSPT pipeline: per-tilt-series constrained refinement and subtomogram
averaging reconstruction — the torch port of pyp_tpu/pipeline/csp.py.

The reference's csp call stack (csp_split -> cspswarm per tilt-series ->
csp refinement modes -> per-series reconstruction dumps -> cspmerge): each
tilt-series runs ops.csp joint refinement (region patch grids through
geometry.region_of), its particle projections are inserted into
reconstruction accumulators with full R_eff matrices, and series-level
accumulators merge with a sum. Inside a torch.distributed group of two
ranks or more (`parallel.pipeline_mesh`) the batched series refinement
splits its series over the ranks (`parallel.csp_refine_batch_sharded`)
and each series' insertion its projection rows
(`parallel.sharded_accumulate_matrices`), as the JAX package shards both
over its mesh; rank 0 alone writes the bundles and maps.

The bundle's "xf". Where the bundle carries the scalar `xf_shift_sign`
(written by the port's `tomo`), sign x xf[:, :2] is the aligning shift of
each tilt, and the content sits at minus it in the raw tilt: the CSP shift
is -sign x xf[:, :2], and the refined shifts are written back the same
way. A bundle without the scalar (aligned by the JAX package) is read and
written as the JAX package does: the CSP shift is xf[:, :2]. The axis is
xf[0, 2], the axis the port's tomogram turns its tilts by, so picks in
that tomogram and the CSP model share one frame.
"""

from __future__ import annotations

import zlib
from pathlib import Path

import numpy as np
import torch

from pyp_tpu_torch import as_f32, parallel, resolve_device
from pyp_tpu_torch.config.params import param
from pyp_tpu_torch.io.metadata import ItemMetadata
from pyp_tpu_torch.utils import Timer, get_logger

logger = get_logger("csp")

# the bundle scalar written by the port's tomo (pipeline/tomo.XF_SIGN)
XF_SIGN = "xf_shift_sign"


def stable_seed(name: str) -> int:
    """A per-series seed that is the same in every process (the JAX
    package seeds from `hash(name)`, which Python salts per process)."""
    return zlib.crc32(str(name).encode()) % (2 ** 31)


def series_shifts_from_xf(meta, xf):
    """CSP tilt shifts (T, 2) (content offset in the raw tilt) from the
    bundle's xf (see the module docstring)."""
    xf = np.asarray(xf, np.float32)
    if XF_SIGN in meta.scalars:
        return (-float(meta.scalars[XF_SIGN]) * xf[:, :2]).astype(np.float32)
    return xf[:, :2].astype(np.float32)


def xf_from_series(meta, tilt_shifts, axis_angles):
    """The bundle's xf (T, 3) for refined CSP shifts and axis angles: the
    inverse of series_shifts_from_xf."""
    sh = np.asarray(tilt_shifts, np.float32)
    if XF_SIGN in meta.scalars:
        sh = -float(meta.scalars[XF_SIGN]) * sh
    return np.concatenate([sh, np.asarray(axis_angles)[:, None]],
                          axis=1).astype(np.float32)


def series_params_from_metadata(meta: ItemMetadata, coords_zyx, eulers,
                                device="cuda"):
    """CspParams for one tilt-series from its metadata bundle and particle
    table (positions in unbinned tomogram voxels, centered)."""
    from pyp_tpu_torch.ops.csp import make_params

    dev = resolve_device(device)
    angles = np.asarray(meta["tlt"], dtype=np.float32)
    T = len(angles)
    xf = meta["xf"] if "xf" in meta else np.zeros((T, 3), dtype=np.float32)
    return make_params(
        angles,
        np.full(T, xf[0, 2] if xf.shape[1] > 2 else 0.0, dtype=np.float32),
        series_shifts_from_xf(meta, xf),
        np.asarray(eulers, dtype=np.float32),
        np.asarray(coords_zyx, dtype=np.float32), device=dev)


def _series_defocus(meta, T):
    return (meta["ctf"][:, :2].astype(np.float32) if "ctf" in meta
            else np.full((T, 2), 20000.0, dtype=np.float32))


def _refine_window(params, T):
    t_lo = int(params.get("csp_UseImagesForRefinementMin") or 0)
    t_hi = int(params.get("csp_UseImagesForRefinementMax") or -1)
    return t_lo, (T - 1 if t_hi < 0 else t_hi)


def _persist(meta, refined, pscores):
    """Refined geometry and scores back into the bundle (resume + interop)."""
    meta["csp_scores"] = np.asarray(pscores, dtype=np.float32)
    meta["xf"] = xf_from_series(meta, refined.tilt_shifts.cpu().numpy(),
                                refined.axis_angles.cpu().numpy())
    meta["tlt"] = refined.tilt_angles.cpu().numpy()
    if parallel.is_writer():
        meta.save()


def csp_swarm_one(item: dict, params: dict, ref_volume, work_dir=".",
                  iteration: int = 2, prev_acc=None, device="cuda"):
    """One tilt-series CSP pass on `device`: refine geometry and poses,
    then insert all particle projections into reconstruction accumulators.

    item: {"name", "tilts" (T, ny, nx), "coords" (P, 3) centered voxels,
    "eulers" (P, 3)}. Returns (refined CspParams, accumulators, scores)."""
    from pyp_tpu_torch.ops import csp as csp_ops

    dev = resolve_device(device)
    name = item["name"]
    meta = ItemMetadata(name, work_dir, mode="tomo").load()
    tilts = as_f32(item["tilts"], dev)
    T = tilts.shape[0]
    pixel = float(params["scope_pixel"])
    box = int(params.get("csp_box") or 64)
    cp = series_params_from_metadata(meta, item["coords"], item["eulers"],
                                     device=dev)
    defocus = _series_defocus(meta, T)
    t_lo, t_hi = _refine_window(params, T)
    tilt_weights = _tilt_window_weights(cp.tilt_angles.cpu().numpy(), params,
                                        t_lo, t_hi)
    cfg = _csp_config(params, iteration, pixel)
    modes = cfg["modes"]

    # region/patch grid (csp_Grid "x,y,z"): patch modes 5/6/7 refine local
    # copies of the tilt geometry per spatial region
    grid_str = str(params.get("csp_Grid") or "").strip()
    patch_grid = None
    if grid_str and any(m in (5, 6, 7) for m in modes):
        patch_grid = tuple(int(v) for v in grid_str.replace(",", ":").split(":"))
        if np.prod(patch_grid) <= 1:
            patch_grid = None

    with Timer(f"csp refinement {name}"):
        if patch_grid is not None:
            per_region, region = csp_refine_regions(
                cp, tilts, defocus, ref_volume, pixel, box, grid=patch_grid,
                modes=tuple(m for m in modes if m in (5, 6, 7)),
                iters_per_mode=cfg["iters"], low_res=cfg["low_res"],
                high_res=cfg["high_res"], reg_weight=cfg["reg_weight"],
                tilt_weights=tilt_weights, voltage_kv=cfg["voltage_kv"],
                cs_mm=cfg["cs_mm"],
                amplitude_contrast=cfg["amplitude_contrast"], device=dev)
            cp = _stitch_regions(cp, per_region, region)
            modes = tuple(m for m in modes if m not in (5, 6, 7))
        refined, scores, particle_scores = csp_ops.csp_refine(
            cp, tilts, defocus, ref_volume, pixel, box, modes=modes,
            iters_per_mode=cfg["iters"], lr=cfg["lr"],
            low_res=cfg["low_res"], high_res=cfg["high_res"],
            reg_weight=cfg["reg_weight"], tilt_weights=tilt_weights,
            voltage_kv=cfg["voltage_kv"], cs_mm=cfg["cs_mm"],
            amplitude_contrast=cfg["amplitude_contrast"],
            grid_tols=cfg["grid_tols"], grid_steps=cfg["grid_steps"],
            spin_step=cfg["spin_step"], angle_step=cfg["angle_step"],
            shift_step=cfg["shift_step"], random_iters=cfg["random_iters"],
            step_tol=cfg["step_tol"], value_tol=cfg["value_tol"],
            return_particle_scores=True, device=dev)
        if params.get("csp_rotreg"):
            refined = refined._replace(
                tilt_angles=_rotreg_track(refined.tilt_angles, params),
                axis_angles=_rotreg_track(refined.axis_angles, params))
    # the step graphs at this series' shapes serve no later stage
    csp_ops.graph.clear()

    # per-tilt movie-frame refinement (csp_frames): dose-weighted polished
    # windows instead of the plain tilt windows
    polished = None
    if params.get("csp_frames") and item.get("tilt_movies") is not None:
        polished, _traj = csp_polish_frames(
            item["tilt_movies"], refined, defocus, ref_volume, params,
            doses=item.get("frame_doses"), device=dev)

    with Timer(f"csp reconstruction {name}"):
        acc = _reconstruct_series(
            tilts, refined, defocus, params, t_lo, t_hi, polished=polished,
            prev_acc=prev_acc, ref_volume=ref_volume)
    _persist(meta, refined, particle_scores)
    return refined, acc, scores


def _tilt_window_weights(tilt_angles, params, t_lo, t_hi):
    """Exposure-window tilt weights + RefineProjectionCutoff: keep only the
    N lowest-|angle| projections for refinement when the cutoff is set."""
    T = len(np.asarray(tilt_angles))
    tw = np.zeros(T, dtype=np.float32)
    tw[t_lo:t_hi + 1] = 1.0
    cutoff = int(params.get("csp_RefineProjectionCutoff") or 0)
    if 0 < cutoff < int(tw.sum()):
        order = np.argsort(np.abs(np.asarray(tilt_angles)))
        keep = [t for t in order if tw[t] > 0][:cutoff]
        tw2 = np.zeros(T, dtype=np.float32)
        tw2[keep] = 1.0
        tw = tw2
    return tw


def _dose_envelope(refined, params, box: int, pixel: float, device):
    """Reconstruction dose weighting (reference reconstruct3d dose block):
    a per-tilt envelope in dose order (|angle| rank approximates the
    acquisition order). Returns (T, box, box//2+1) weights or None."""
    if not params.get("reconstruct_dose_weighting_enable"):
        return None
    from pyp_tpu_torch.core.ctf import dose_weight_2d

    angles = refined.tilt_angles.cpu().numpy()
    if params.get("dose_weight_global"):
        order = np.arange(len(angles))
    elif params.get("scope_dose_symmetric", True):
        order = np.argsort(np.argsort(np.abs(angles)))
    else:  # sequential acquisition (-60 -> +60)
        order = np.arange(len(angles))
    wpath = str(params.get("dose_weight_weights") or "")
    if wpath:
        # external per-tilt weight table: one scalar per tilt
        if Path(wpath).exists():
            wtab = np.loadtxt(wpath, dtype=np.float32).reshape(-1)
            if len(wtab) >= len(angles):
                env = np.ones((len(angles), box, box // 2 + 1), np.float32)
                env *= wtab[:len(angles), None, None]
                return torch.as_tensor(env, device=device)
        logger.warning("dose_weight_weights %s unusable — falling back to "
                       "the analytic envelope", wpath)
    if str(params.get("dose_weight_method") or "grant") == "frame":
        from pyp_tpu_torch.core.ctf import frame_damage_weights

        ranks = order.astype(np.float32) / max(len(order) - 1, 1)
        return frame_damage_weights(
            (box, box), ranks,
            fraction=float(params.get("dose_weight_fraction") or 4.0),
            transition=float(params.get("dose_weight_transition") or 0.75),
            multiply=bool(params.get("dose_weight_multiply", True)),
            device=device)
    cum = ((order + 1.0) * float(params.get("scope_dose_rate") or 1.0)
           + float(params.get("scope_init_dose") or 0.0))
    return dose_weight_2d((box, box), pixel,
                          torch.as_tensor(cum.astype(np.float32),
                                          device=device))


def _reconstruct_series(tilts, refined, defocus, params, t_lo, t_hi,
                        polished=None, prev_acc=None, ref_volume=None):
    """Insert one refined series' projections into reconstruction
    accumulators on the device of `tilts` (a tensor): one windowing gather
    and one insertion."""
    from pyp_tpu_torch.ops import csp as csp_ops
    from pyp_tpu_torch.ops import reconstruct as rec

    dev = tilts.device
    T, ny, nx = tilts.shape[-3:]
    box = int(params.get("csp_box") or 64)
    pixel = float(params["scope_pixel"])
    R_eff = csp_ops.effective_rotations(refined)             # (T, P, 3, 3)
    pred = csp_ops.project_positions(refined).cpu().numpy()  # (T, P, 2)
    depth = csp_ops.particle_depth(refined)                  # (T, P)
    P = pred.shape[1]
    center = np.array([ny // 2, nx // 2])
    dose_env = _dose_envelope(refined, params, box, pixel, dev)

    r_lo = int(params.get("csp_UseImagesForReconstructionMin") or 0)
    r_hi = int(params.get("csp_UseImagesForReconstructionMax") or -1)
    r_lo, r_hi = max(t_lo, r_lo), (t_hi if r_hi < 0 else min(t_hi, r_hi))
    ts = np.arange(r_lo, r_hi + 1)
    Tr = len(ts)
    pred_s = pred[ts]
    ci, inb = csp_ops.window_centers_of(pred_s, (ny, nx), box)
    if polished is not None:
        wins = as_f32(np.asarray(polished)[ts], dev)
    else:
        wins = csp_ops.cut_windows(tilts[torch.as_tensor(ts, device=dev)], ci,
                                   box)
    if dose_env is not None:
        wins = torch.fft.irfft2(
            torch.fft.rfft2(wins) * dose_env[torch.as_tensor(ts, device=dev)][:, None],
            s=(box, box))
    windows = wins.reshape(Tr * P, box, box)
    # residual shift: content sits at pred - window_center; the stored
    # shift centers it
    rows_shift = (-(pred_s + center - ci)).reshape(Tr * P, 2).astype(np.float32)
    tsd = torch.as_tensor(ts, device=dev)
    rows_R = R_eff[tsd].reshape(Tr * P, 3, 3)
    df_mean = as_f32(defocus[ts, :2].mean(axis=1, keepdims=True), dev)
    rows_df = (df_mean + depth[tsd] * pixel).reshape(Tr * P)
    rows_sub = np.tile(np.arange(P) % 2, Tr)
    rows_w = inb.reshape(Tr * P).astype(np.float32)
    kw = dict(voltage_kv=float(params["scope_voltage"]),
              cs_mm=float(params["scope_cs"]),
              amplitude_contrast=float(params["scope_wgh"]),
              prev=prev_acc, iewald=int(params.get("reconstruct_iewald") or 0))
    if abs(kw["iewald"]) >= 2 and ref_volume is not None:
        # reference-based Ewald (IEWALD ±2): predict the opposite sphere
        # branch from the current map (cropped to the window box if needed)
        from pyp_tpu_torch.core.fft import fourier_crop_3d
        from pyp_tpu_torch.ops.fourier_slice import volume_to_fourier

        rv = as_f32(ref_volume, dev)
        if rv.shape[-1] > box:
            rv = fourier_crop_3d(rv, (box, box, box))
        if rv.shape[-1] == box:
            kw["ref_fourier"] = volume_to_fourier(rv, pad=2)
    mesh = parallel.pipeline_mesh(params, dev)
    if mesh is not None:
        # the (tilt x particle) projection rows split over the ranks; one
        # all_reduce merges the accumulators (the cspmerge reduction)
        return parallel.sharded_accumulate_matrices(
            mesh, windows, rows_R.detach(), rows_shift, rows_df.detach(),
            rows_sub, rows_w, box, pixel, **kw)
    return rec.accumulate_matrices(
        windows, rows_R.detach(), as_f32(rows_shift, dev), rows_df.detach(),
        torch.as_tensor(rows_sub, device=dev), as_f32(rows_w, dev),
        box, pixel, **kw)


def _rotreg_track(values, params: dict):
    """Smooth one per-tilt angle track per csp_rotreg_method: AB1 = the
    first-order Gaussian kernel, AB2 (default) = outlier-rejecting spline,
    XD = the wrap-aware angular spline (reference rotreg enum)."""
    from pyp_tpu_torch.analysis.fit import (fit_angular_trajectory,
                                            fit_spline_trajectory,
                                            regularize_trajectories)

    method = str(params.get("csp_rotreg_method") or "AB2")
    mads = float(params.get("csp_reg_outlier_mads") or 5.0)
    v = values.detach().cpu().numpy()
    if method == "AB1":
        out = regularize_trajectories(
            v[None, :, None], method="gaussian",
            time_sigma=float(params.get("csp_time_sigma") or 21.0))[0, :, 0]
    elif method == "XD":
        out = fit_angular_trajectory(v, outlier_mads=mads)
    else:
        out = fit_spline_trajectory(v, outlier_mads=mads)
    return torch.as_tensor(out.astype(np.float32), device=values.device)


def _csp_config(params: dict, iteration: int, pixel: float):
    """Shared mode-schedule configuration for a CSP pass (modes, band,
    grid-search tolerances) — one place for the single-series and the
    batched path."""
    switches = [params.get(k) for k in ("csp_refine_micrographs",
                                        "csp_refine_particles",
                                        "csp_refine_ctf")]
    if any(s is not None for s in switches):
        from pyp_tpu_torch.config.blocks import block_mode_schedule

        modes_str = block_mode_schedule(bool(switches[0]), bool(switches[1]),
                                        bool(switches[2]))
    else:
        modes_str = str(params.get("csp_refine_modes") or "3:0:2:1")
    modes = tuple(int(m) for m in modes_str.split(":"))
    rhref = float(param(params.get("csp_rhref") or "12", iteration))
    grid_tols = None
    if params.get("csp_GridSearch"):
        grid_tols = {
            0: (float(params.get("csp_ToleranceMicrographTiltAngles") or 10.0),
                float(params.get("csp_ToleranceMicrographTiltAxisAngles")
                      or 0.0)),
            3: float(params.get("csp_ToleranceMicrographShifts") or 20.0),
            5: float(params.get("csp_ToleranceMicrographShifts") or 20.0),
            # mode 4 refines one per-tilt defocus offset: the search radius
            # covers whichever axis tolerance is wider
            4: max(float(params.get("csp_ToleranceMicrographDefocus1")
                         or 2000.0),
                   float(params.get("csp_ToleranceMicrographDefocus2")
                         or 0.0)),
            1: (float(params.get("csp_ToleranceParticlesPsi") or 10.0),
                float(params.get("csp_ToleranceParticlesTheta") or 10.0),
                float(params.get("csp_ToleranceParticlesPhi") or 10.0)),
            7: (float(params.get("csp_ToleranceParticlesPsi") or 10.0),
                float(params.get("csp_ToleranceParticlesTheta") or 10.0),
                float(params.get("csp_ToleranceParticlesPhi") or 10.0)),
            2: float(params.get("csp_ToleranceParticlesShifts") or 10.0),
            6: float(params.get("csp_ToleranceParticlesShifts") or 10.0),
        }
        if float(params.get("csp_ToleranceMicrographAstigmatism") or 0) > 0:
            logger.warning(
                "csp_ToleranceMicrographAstigmatism set, but per-tilt "
                "astigmatism is not a refinable CSP block (defocus offset "
                "only); value ignored")
    return dict(
        modes=modes,
        rhref=rhref,
        low_res=float(params.get("csp_rlref") or 60.0),
        high_res=max(rhref, 2.5 * pixel),
        iters=int(params.get("csp_OptimizerIters") or 20),
        lr=float(params.get("csp_OptimizerStepLength") or 0.3),
        # 0 turns the trajectory penalty off (the JAX package reads 0 as
        # its default 0.1)
        reg_weight=(0.1 if params.get("csp_transreg") is None
                    else float(params["csp_transreg"])),
        grid_tols=grid_tols,
        grid_steps=int(params.get("csp_GridSearchSteps") or 9),
        # csp_InitialSkip suppresses the spin-ring init pass
        spin_step=(0.0 if params.get("csp_InitialSkip")
                   else float(params.get("csp_spin_search") or 0.0)),
        angle_step=float(params.get("csp_AngleStep") or 0.0),
        shift_step=float(params.get("csp_ShiftStep") or 0.0),
        random_iters=int(params.get("csp_NumberOfRandomIterations") or 0),
        step_tol=float(params.get("csp_OptimizerStepTolerance") or 0.0),
        value_tol=float(params.get("csp_OptimizerValueTolerance") or 0.0),
        voltage_kv=float(params["scope_voltage"]),
        cs_mm=float(params["scope_cs"]),
        amplitude_contrast=float(params["scope_wgh"]),
    )


def _pad_edge(a, n_target, axis=0):
    """Pad along axis to n_target by edge replication."""
    a = np.asarray(a)
    pad = n_target - a.shape[axis]
    if pad <= 0:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, pad)
    return np.pad(a, widths, mode="edge")


def csp_swarm_batch(items: list, params: dict, ref_volume, work_dir=".",
                    iteration: int = 2, prev_acc=None, device="cuda"):
    """Batched cspswarm on `device`: S tilt-series padded to common (T, P)
    with zero validity weights, refined together (ops.csp.csp_refine_batch,
    vectorized over the series: each series' result is the sequential
    one), their reconstruction accumulators chained.

    items: dicts as csp_swarm_one takes. Returns (refined list of
    CspParams, chained accumulators, mode-score lists, per-particle-score
    list)."""
    from pyp_tpu_torch.ops import csp as csp_ops
    from pyp_tpu_torch.ops.fourier_slice import volume_to_fourier
    from pyp_tpu_torch.ops.refine3d import make_mask_points

    dev = resolve_device(device)
    pixel = float(params["scope_pixel"])
    box = int(params.get("csp_box") or 64)
    cfg = _csp_config(params, iteration, pixel)
    Fref = volume_to_fourier(as_f32(ref_volume, dev))
    mask_pts = as_f32(make_mask_points(box, pixel, cfg["low_res"],
                                       cfg["high_res"]), dev)

    setups = []
    for item in items:
        meta = ItemMetadata(item["name"], work_dir, mode="tomo").load()
        tilts = as_f32(item["tilts"], dev)
        T = tilts.shape[0]
        cp = series_params_from_metadata(meta, item["coords"],
                                         item["eulers"], device=dev)
        t_lo, t_hi = _refine_window(params, T)
        tw = _tilt_window_weights(cp.tilt_angles.cpu().numpy(), params,
                                  t_lo, t_hi)
        xv, w_centers, valid = csp_ops.prepare_series_windows(
            tilts, cp, box, mask_pts, device=dev)
        setups.append(dict(meta=meta, tilts=tilts, cp=cp,
                           defocus=_series_defocus(meta, T), tw=tw, xv=xv,
                           w_centers=w_centers, valid=valid, t_lo=t_lo,
                           t_hi=t_hi, name=item["name"]))

    Tm = max(s["tilts"].shape[0] for s in setups)
    Pm = max(s["cp"].particle_pos.shape[0] for s in setups)
    G = setups[0]["xv"].shape[-1]

    def pad_series(s):
        cp = s["cp"]
        T = s["tilts"].shape[0]
        P = cp.particle_pos.shape[0]
        cp_p = csp_ops.CspParams(*(
            as_f32(_pad_edge(leaf.cpu().numpy(), Tm if k in (0, 1, 2, 5) else Pm), dev)
            for k, leaf in enumerate(cp)))
        xv = torch.zeros((Tm, Pm, G), dtype=s["xv"].dtype, device=dev)
        xv[:T, :P] = s["xv"]
        wc = np.zeros((Tm, Pm, 2), dtype=np.float32)
        wc[:T, :P] = s["w_centers"]
        va = np.zeros((Tm, Pm), dtype=np.float32)
        va[:T, :P] = s["valid"]
        # random particle subsampling (csp RandomParticles / RandomSkipRatio):
        # skipped particles carry zero weight for this pass and keep their
        # parameters; the seed is stable per series name
        skip_ratio = float(params.get("csp_RandomSkipRatio") or 0.0)
        rand_n = (int(params.get("csp_RandomParticles") or 0)
                  if params.get("refine_abinit") else 0)
        if skip_ratio > 0.0 or 0 < rand_n < P:
            srng = np.random.RandomState(stable_seed(s["name"]))
            keep = np.arange(P)
            if 0 < rand_n < P:
                keep = srng.choice(P, size=rand_n, replace=False)
            if skip_ratio > 0.0:
                keep = srng.choice(
                    keep, size=max(1, int(round(len(keep)
                                                * (1 - skip_ratio)))),
                    replace=False)
            mask = np.zeros(Pm, dtype=np.float32)
            mask[keep] = 1.0
            va *= mask[None, :]
        tw = np.zeros(Tm, dtype=np.float32)
        tw[:T] = s["tw"]
        return cp_p, xv, wc, va, _pad_edge(s["defocus"], Tm), tw

    padded = [pad_series(s) for s in setups]
    cp_b = csp_ops.CspParams(*(torch.stack(x) for x in
                               zip(*(p[0] for p in padded))))
    xv_b = torch.stack([p[1] for p in padded])
    wc_b, va_b, df_b, tw_b = (
        as_f32(np.stack([p[i] for p in padded]), dev) for i in (2, 3, 4, 5))
    offsets_by_mode, spin_offsets = csp_ops.build_mode_offsets(
        cfg["modes"], cfg["grid_tols"], cfg["grid_steps"], cfg["spin_step"],
        angle_step=cfg["angle_step"], shift_step=cfg["shift_step"],
        random_iters=cfg["random_iters"])
    mesh = parallel.pipeline_mesh(params, dev)
    kw = dict(iters_per_mode=cfg["iters"], lr=cfg["lr"],
              reg_weight=cfg["reg_weight"], voltage_kv=cfg["voltage_kv"],
              cs_mm=cfg["cs_mm"],
              amplitude_contrast=cfg["amplitude_contrast"],
              step_tol=cfg["step_tol"], value_tol=cfg["value_tol"],
              series_vmap=True)
    with Timer(f"csp batch refinement ({len(setups)} series)"):
        if mesh is not None and len(setups) > 1:
            # series are data-parallel across the ranks: each rank runs
            # whole series (the reference fans one cspswarm task per series)
            refined_b, mode_scores_b, pscores_b = \
                parallel.csp_refine_batch_sharded(
                    mesh, cp_b, xv_b, wc_b, df_b, mask_pts, Fref, tw_b, va_b,
                    offsets_by_mode, spin_offsets, cfg["modes"], box, pixel,
                    **kw)
        else:
            refined_b, mode_scores_b, pscores_b = csp_ops.csp_refine_batch(
                cp_b, xv_b, wc_b, df_b, mask_pts, Fref, tw_b, va_b,
                offsets_by_mode, spin_offsets, cfg["modes"], box, pixel, **kw)
        mode_scores_b = mode_scores_b.cpu().numpy()
        pscores_b = pscores_b.cpu().numpy()
    # the step graphs at this batch's shapes serve no later stage
    csp_ops.graph.clear()

    refined_list, scores_list, pscore_list = [], [], []
    acc = prev_acc
    for i, s in enumerate(setups):
        T = s["tilts"].shape[0]
        P = s["cp"].particle_pos.shape[0]
        r = csp_ops.CspParams(*(
            leaf[i][:(T if k in (0, 1, 2, 5) else P)]
            for k, leaf in enumerate(refined_b)))
        if params.get("csp_rotreg"):
            r = r._replace(tilt_angles=_rotreg_track(r.tilt_angles, params),
                           axis_angles=_rotreg_track(r.axis_angles, params))
        acc = _reconstruct_series(
            s["tilts"], r, s["defocus"], params, s["t_lo"], s["t_hi"],
            prev_acc=acc, ref_volume=ref_volume)
        _persist(s["meta"], r, pscores_b[i, :P])
        refined_list.append(r)
        scores_list.append([float(v) for v in mode_scores_b[i]])
        pscore_list.append(pscores_b[i, :P])
    return refined_list, acc, scores_list, pscore_list


def csp_merge(accumulators, box: int, params: dict, work_dir=".",
              dataset="dataset", iteration: int = 2):
    """Global merge: sum per-series accumulators (tensors on one device),
    finalize half maps + FSC, write outputs (the cspmerge job)."""
    from pyp_tpu_torch.core import fsc as fsc_mod
    from pyp_tpu_torch.io import mrc
    from pyp_tpu_torch.ops import reconstruct as rec

    acc = rec.merge_accumulators(accumulators)
    out = rec.finalize(acc, box)
    pixel = float(params["scope_pixel"])
    maps_dir = Path(work_dir) / "maps"
    maps_dir.mkdir(parents=True, exist_ok=True)
    stem = f"{dataset}_csp_{iteration:02d}"
    for suffix, vol in (("", out.volume), ("_half1", out.half1),
                        ("_half2", out.half2)):
        if parallel.is_writer():
            mrc.write(vol.cpu().numpy().astype(np.float32),
                      maps_dir / f"{stem}{suffix}.mrc", pixel_size=pixel)
    res = float(fsc_mod.resolution_at_threshold(out.freqs.cpu(),
                                                out.fsc.cpu(), pixel, 0.143))
    logger.info("csp merge: FSC(0.143) = %.2f Å", res)
    return out, res


def _stitch_regions(full, per_region, region):
    """Merge per-region refined CspParams back into one record: particle
    blocks scatter to their rows; per-tilt geometry takes the particle-
    weighted mean over regions."""
    eulers = full.particle_eulers.clone()
    pos = full.particle_pos.clone()
    tilt_fields = {"tilt_angles": 0.0, "axis_angles": 0.0,
                   "tilt_shifts": 0.0, "defocus_offsets": 0.0}
    total = 0
    for r, sub in enumerate(per_region):
        if sub is None:
            continue
        sel = torch.as_tensor(np.where(np.asarray(region) == r)[0],
                              device=eulers.device)
        eulers[sel] = sub.particle_eulers
        pos[sel] = sub.particle_pos
        for k in tilt_fields:
            tilt_fields[k] = tilt_fields[k] + len(sel) * getattr(sub, k)
        total += len(sel)
    if total == 0:
        return full
    return full._replace(particle_eulers=eulers, particle_pos=pos,
                         **{k: v / total for k, v in tilt_fields.items()})


def csp_refine_regions(params_in, tilt_images, tilt_defocus, ref_volume,
                       pixel_size, boxsize, grid=(2, 2, 1), modes=(5, 6),
                       bounds=None, device="cuda", **kw):
    """Patch-based CSP (reference modes 5/6/7 and csp_Grid): particles are
    partitioned into a spatial grid of regions; each region refines its own
    copy of the per-tilt geometry, with particle blocks refined within the
    region subset. Returns (per_region_params: list[CspParams or None],
    region_of_particle (P,)); regions with no particles give None."""
    from pyp_tpu_torch.core.geometry import region_of
    from pyp_tpu_torch.ops import csp as csp_ops

    dev = resolve_device(device)
    pos = params_in.particle_pos.cpu().numpy()   # (P, 3) (z, y, x)
    if bounds is None:
        lo = pos.min(axis=0) - 1.0
        hi = pos.max(axis=0) + 1.0
    else:
        lo, hi = bounds
    # grid given as (x, y, z) like csp_Grid; positions are (z, y, x)
    grid_zyx = np.asarray(grid[::-1], dtype=np.int64)
    region = region_of(pos, lo, hi, grid_zyx)
    tilt_images = as_f32(tilt_images, dev)
    out = []
    for r in range(int(np.prod(grid_zyx))):
        sel = np.where(region == r)[0]
        if len(sel) == 0:
            out.append(None)
            continue
        idx = torch.as_tensor(sel, device=params_in.particle_pos.device)
        sub = params_in._replace(
            particle_eulers=params_in.particle_eulers[idx],
            particle_pos=params_in.particle_pos[idx])
        refined, _scores = csp_ops.csp_refine(
            sub, tilt_images, tilt_defocus, ref_volume, pixel_size, boxsize,
            modes=tuple(modes), device=dev, **kw)
        out.append(refined)
    return out, region


def csp_classify(items_refined, params: dict, references, work_dir=".",
                 iteration: int = 2, device="cuda"):
    """Subtomogram classification on `device`: given refined per-series
    CspParams and K reference volumes, score every particle against every
    reference (CTF-weighted NCC over its tilt projections, streamed one
    tilt at a time), convert to occupancies, and reconstruct each class
    with occupancy-weighted matrix-pose insertion.

    items_refined: dicts {"name", "tilts", "params": CspParams, "defocus"
    (T, 2)}. Returns (per-class Reconstruction list, occupancies per item,
    resolutions)."""
    from pyp_tpu_torch.analysis import occupancies as occ_mod
    from pyp_tpu_torch.core import fsc as fsc_mod
    from pyp_tpu_torch.ops import csp as csp_ops
    from pyp_tpu_torch.ops import kernels
    from pyp_tpu_torch.ops import reconstruct as rec
    from pyp_tpu_torch.ops.extract import window_particles
    from pyp_tpu_torch.ops.fourier_slice import volume_to_fourier
    from pyp_tpu_torch.ops.refine3d import make_mask_points

    dev = resolve_device(device)
    K = len(references)
    pixel = float(params["scope_pixel"])
    box = int(params.get("csp_box") or 64)
    rhref = float(param(params.get("csp_rhref") or "12", iteration))
    mask_pts = as_f32(make_mask_points(
        box, pixel, float(params.get("csp_rlref") or 60.0),
        max(rhref, 2.5 * pixel)), dev)
    Frefs = [volume_to_fourier(as_f32(r, dev)) for r in references]

    accs = [None] * K
    occ_per_item = []
    voltage = float(params["scope_voltage"])
    cs = float(params["scope_cs"])
    w_amp = float(params["scope_wgh"])
    for item in items_refined:
        cp = csp_ops.CspParams(*(as_f32(x, dev) for x in item["params"]))
        tilts = as_f32(item["tilts"], dev)
        defocus = np.asarray(item["defocus"], dtype=np.float32)
        T, ny, nx = tilts.shape
        P = cp.particle_pos.shape[0]
        pred = csp_ops.project_positions(cp).cpu().numpy()
        depth = csp_ops.particle_depth(cp).cpu().numpy()
        R_eff = csp_ops.effective_rotations(cp)              # (T, P, 3, 3)
        offs = cp.defocus_offsets.cpu().numpy()
        center = np.array([ny // 2, nx // 2])

        def tilt_geometry(t):
            ci, inb = csp_ops.window_centers_of(pred[t], (ny, nx), box)
            dshift = (pred[t] + center - ci).astype(np.float32)
            df_t = (defocus[t, :2].mean() + offs[t]
                    + depth[t] * pixel).astype(np.float32)
            return ci, inb.astype(np.float32), dshift, df_t

        # pass 1: per-particle per-class scores, streamed over tilts
        scores = np.zeros((T, P, K), np.float64)
        valid = np.zeros((T, P), np.float64)
        for t in range(T):
            ci, valid_t, dshift, df_t = tilt_geometry(t)
            wins_t = window_particles(tilts[t], torch.as_tensor(ci), box)
            xv = _gather_windows(wins_t, mask_pts)           # (P, G)
            for k in range(K):
                u = kernels.csp_slice_gather(
                    R_eff[t], mask_pts, Frefs[k],
                    float(Frefs[k].shape[0] // box))
                ncc = kernels.csp_score(
                    as_f32(dshift, dev), as_f32(df_t, dev), xv, u, mask_pts,
                    box, pixel, voltage, cs, w_amp)
                scores[t, :, k] = ncc.cpu().numpy()
            valid[t] = valid_t
        # per-particle LogP = tilt-weighted score average (the reference's
        # tomo occupancy weighting, occupancies.py:154-168)
        logp = occ_mod.aggregate_tilt_logp(
            scores, valid, cp.tilt_angles.cpu().numpy(),
            score_weighting=bool(params.get("refine_score_weighting")))
        G = mask_pts.shape[0]
        occ = occ_mod.occupancies_from_logp(logp * G * 0.5)  # sharpen by band size
        occ_per_item.append(occ)

        # pass 2: occupancy-weighted reconstruction, streamed the same way
        sub = torch.as_tensor(np.arange(P) % 2, device=dev)
        for t in range(T):
            ci, valid_t, dshift, df_t = tilt_geometry(t)
            wins_t = window_particles(tilts[t], torch.as_tensor(ci), box)
            for k in range(K):
                accs[k] = rec.accumulate_matrices(
                    wins_t, R_eff[t], as_f32(-dshift, dev), as_f32(df_t, dev),
                    sub, as_f32(valid_t * occ[:, k].astype(np.float32) / 100.0,
                                dev),
                    box, pixel, voltage_kv=voltage, cs_mm=cs,
                    amplitude_contrast=w_amp, prev=accs[k])

    outs, resolutions = [], []
    for k in range(K):
        out = rec.finalize(accs[k], box)
        outs.append(out)
        resolutions.append(float(fsc_mod.resolution_at_threshold(
            out.freqs.cpu(), out.fsc.cpu(), pixel, 0.143)))
    return outs, occ_per_item, resolutions


def _gather_windows(wins, mask_pts):
    """(P, box, box) windows -> (P, G) spectrum samples at mask points."""
    from pyp_tpu_torch.ops.fourier_slice import (gather_2d_hermitian,
                                                 image_to_fourier)

    return gather_2d_hermitian(image_to_fourier(wins), mask_pts)


def csp_polish_frames(tilt_movies, cp, defocus, ref_volume, params,
                      doses=None, device="cuda"):
    """Per-tilt movie-frame refinement (the reference's CSPT frame axis) on
    `device`: for each tilt movie, window every particle from every raw
    frame at its CSP-projected position, jointly refine per-(particle,
    frame) 2D trajectories against CTF-weighted projections of the
    reference at the CSP effective rotations (ops.polish.
    refine_trajectories), regularize them, and rebuild dose-weighted
    particle windows.

    tilt_movies: T arrays (F_t, ny, nx); cp: refined CspParams; defocus
    (T, 2). Returns (windows (T, P, box, box) numpy, trajectories: list of
    (P, F_t, 2))."""
    from pyp_tpu_torch.analysis.fit import regularize_trajectories
    from pyp_tpu_torch.core.geometry import matrix_to_euler
    from pyp_tpu_torch.ops import csp as csp_ops
    from pyp_tpu_torch.ops import polish as polish_ops
    from pyp_tpu_torch.ops.extract import extract_from_frames
    from pyp_tpu_torch.ops.fourier_slice import volume_to_fourier
    from pyp_tpu_torch.ops.refine3d import make_mask_points

    dev = resolve_device(device)
    cp = csp_ops.CspParams(*(as_f32(x, dev) for x in cp))
    pixel = float(params["scope_pixel"])
    box = int(params.get("csp_box") or 64)
    Fref = volume_to_fourier(as_f32(ref_volume, dev))
    mask_pts = as_f32(make_mask_points(
        box, pixel, float(params.get("csp_rlref") or 60.0),
        max(float(param(params.get("csp_rhref") or "12", 2)), 2.5 * pixel)),
        dev)
    R_eff = csp_ops.effective_rotations(cp)                  # (T, P, 3, 3)
    pred = csp_ops.project_positions(cp).cpu().numpy()       # (T, P, 2)
    depth = csp_ops.particle_depth(cp).cpu().numpy()         # (T, P)
    defocus = np.asarray(defocus, np.float32)
    T = len(tilt_movies)
    P = pred.shape[1]
    out_windows, out_traj = [], []
    for t in range(T):
        frames = as_f32(tilt_movies[t], dev)
        F_t, ny, nx = frames.shape
        center = np.array([ny // 2, nx // 2])
        ci = np.round(pred[t] + center).astype(np.int32)
        ci = np.clip(ci, box // 2, [ny - box // 2 - 1, nx - box // 2 - 1])
        windows = extract_from_frames(frames, ci, box, invert=False,
                                      normalize=False, device=dev)
        phi, theta, psi = matrix_to_euler(R_eff[t])
        dsh = as_f32((pred[t] + center - ci).astype(np.float32), dev)
        poses = torch.stack([phi, theta, psi, dsh[:, 0], dsh[:, 1]], dim=1)
        df_t = (defocus[t, :2].mean() + depth[t] * pixel).astype(np.float32)
        ctf_t = np.stack([df_t, df_t, np.zeros(P), np.zeros(P)],
                         axis=1).astype(np.float32)
        traj, _score = polish_ops.refine_trajectories(
            windows, poses, as_f32(ctf_t, dev), Fref, mask_pts, box, pixel,
            iters=int(params.get("polish_iters") or 30),
            voltage_kv=float(params["scope_voltage"]),
            cs_mm=float(params["scope_cs"]),
            amplitude_contrast=float(params["scope_wgh"]), device=dev)
        # spline-with-outlier-weights regularization across frames +
        # spatial coupling across particles (reference regularize family)
        traj = as_f32(regularize_trajectories(
            traj.cpu().numpy(), positions=ci.astype(np.float64),
            time_sigma=float(params.get("csp_time_sigma") or 21.0),
            spatial_sigma=float(params.get("csp_spatial_sigma") or 500.0),
            method=str(params.get("csp_transreg_method") or "spline"),
            outlier_mads=float(params.get("csp_reg_outlier_mads") or 5.0),
        ).astype(np.float32), dev)
        d = (as_f32(doses[t], dev) if doses is not None
             else torch.arange(1, F_t + 1, dtype=torch.float32, device=dev))
        out_windows.append(polish_ops.polished_average(
            windows, traj, d, pixel).cpu().numpy())
        out_traj.append(traj.cpu().numpy())
        logger.info("csp frame refinement tilt %d: %d particles x %d frames",
                    t, P, F_t)
    return np.stack(out_windows), out_traj
