"""Iterative 3D refinement loop — the torch port of pyp_tpu/pipeline/refine.py.

Per iteration: optional reference masking (refine_masking_method auto or
file), pose refinement over particle batches with the FRM engine (the
default: a direction bank per reference, with gold-standard half banks and
a final-iteration sub-lattice polish) or the gather engine (global search
plus local gradient polish), reconstruction of half maps, FSC/resolution
bookkeeping, and durable state (maps/<dataset>_r01_02.mrc, half maps,
.cistem table, FSC text, history JSON) in the same files the JAX package
writes, so `refine_iter` resumes a run started by either package. The loop
also applies the calibrated beam tilt (scope_beam_tilt_x/y), the one-shot
beam-tilt estimate (refine_beamtilt) and per-particle defocus refinement
(refine_fdef).

The reconstruction honours score shaping (reconstruct_min*/max*,
reconstruct_score_fraction, reconstruct_shapr), likelihood blurring
(reconstruct_lblur) and Ewald-sphere insertion (reconstruct_iewald ±1, ±2
against the current map); the final iteration can write the Guinier-
sharpened map (reconstruct_fbfact, <stem>_sharp.mrc); each iteration can
score a PDB model against its map (model_fit, <dataset>_model_fit.txt);
and the end of the run can write the matching projections at the final
poses (refine_fmatch, <dataset>_match.mrc). `check_ported` refuses only an
engine other than frm and gather: there is no silent switch to another
engine or device.

Inside a torch.distributed group of two ranks or more
(`parallel.pipeline_mesh`), every iteration splits its rows over the
ranks, as the JAX package shards them over its mesh: the gather engine
through `parallel.sharded_refine_batch`, the FRM engine by each rank
refining its contiguous range against both gold-standard banks, the
reconstructions through `parallel.reconstruct_sharded`; results are
replicated, and rank 0 alone writes maps/.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from pyp_tpu_torch import as_f32, parallel, resolve_device
from pyp_tpu_torch.analysis import scores
from pyp_tpu_torch.analysis.plots import plot_iteration_changes
from pyp_tpu_torch.config.params import param
from pyp_tpu_torch.core import fsc as fsc_mod
from pyp_tpu_torch.core.fft import fourier_crop_3d
from pyp_tpu_torch.core.filters import normalize_images, soft_circular_mask
from pyp_tpu_torch.core.geometry import euler_to_matrix
from pyp_tpu_torch.io import cistem, mrc
from pyp_tpu_torch.ops import frm
from pyp_tpu_torch.ops import reconstruct as rec
from pyp_tpu_torch.ops import refine3d
from pyp_tpu_torch.ops.fourier_slice import project_real, volume_to_fourier
from pyp_tpu_torch.postprocess.core import (auto_mask, guinier_bfactor,
                                            sharpen_map)
from pyp_tpu_torch.stream.web import Web
from pyp_tpu_torch.utils import Timer, get_logger

logger = get_logger("refine")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def table_to_ctf_params(table: cistem.Table) -> np.ndarray:
    return np.stack([
        table["defocus_1"], table["defocus_2"], table["defocus_angle"],
        table["phase_shift"] if "phase_shift" in table else np.zeros(table.n_rows),
    ], axis=1).astype(np.float32)


def table_to_poses(table: cistem.Table, pixel: float) -> np.ndarray:
    """Pose array from a .cistem table; shifts stored in Å -> pixels."""
    return np.stack([
        table["phi"], table["theta"], table["psi"],
        table["y_shift"] / pixel, table["x_shift"] / pixel,
    ], axis=1).astype(np.float32)


def poses_into_table(table: cistem.Table, result, pixel: float,
                     freeze: set | None = None):
    """freeze: per-DOF toggles OFF keep the previous table value (the
    refine_refine_angle_{phi,theta,psi} / refine_refine_shift{x,y}
    switches)."""
    freeze = freeze or set()
    if "phi" not in freeze:
        table["phi"] = _np(result.phi)
    if "theta" not in freeze:
        table["theta"] = _np(result.theta)
    if "psi" not in freeze:
        table["psi"] = _np(result.psi)
    if "shifty" not in freeze:
        table["y_shift"] = _np(result.shift_y) * pixel
    if "shiftx" not in freeze:
        table["x_shift"] = _np(result.shift_x) * pixel
    table["score"] = _np(result.score)
    table["logp"] = _np(result.logp)
    table["sigma"] = _np(result.sigma)
    return table


def _dof_freeze(params: dict) -> set:
    """DOFs whose refine_refine_* switch is explicitly OFF."""
    frozen = set()
    for dof, key in (("phi", "refine_refine_angle_phi"),
                     ("theta", "refine_refine_angle_theta"),
                     ("psi", "refine_refine_angle_psi"),
                     ("shiftx", "refine_refine_shiftx"),
                     ("shifty", "refine_refine_shifty")):
        if params.get(key) is not None and not params.get(key):
            frozen.add(dof)
    return frozen


def _reconstruct(stack, poses, ctf_params, pixel, rc_kwargs, device,
                 mesh=None, crop_to=None):
    """`reconstruct.reconstruct` on `device`, or over `mesh`."""
    if mesh is not None:
        return parallel.reconstruct_sharded(mesh, stack, poses, ctf_params,
                                            pixel, crop_to=crop_to,
                                            **rc_kwargs)
    return rec.reconstruct(stack, poses, ctf_params, pixel, crop_to=crop_to,
                           device=device, **rc_kwargs)


def reconstruct_banded(stack, poses, ctf_params, pixel, high_res, rc_kwargs,
                       device="cpu", mesh=None):
    """Reconstruction on the band-limited auto-crop grid, Fourier-padded
    back to the data box with the FSC remapped shell-for-shell onto the data
    axis. An intermediate map only needs fidelity to the matching band
    `high_res`, so cropping cuts the insertion work by (n_rec/n)^2. With
    `mesh` the insertion is split over its ranks."""
    n_data = int(stack.shape[-1])
    r_max = n_data * pixel / max(high_res, 2.0 * pixel)
    n_rec = min(n_data, int(np.ceil((2.0 * r_max + 8.0) / 16.0)) * 16)
    if n_rec >= 0.9 * n_data:  # negligible saving: skip crop+upsample
        return _reconstruct(stack, poses, ctf_params, pixel, rc_kwargs,
                            device, mesh)
    out = _reconstruct(stack, poses, ctf_params, pixel, rc_kwargs, device,
                       mesh, crop_to=n_rec)
    # shell k on the crop grid IS data wavenumber k: remap the FSC onto the
    # data shell axis (zero beyond the band) and upsample the maps by
    # centered Fourier pad
    dev = out.fsc.device
    fsc_full = torch.zeros(n_data // 2, dtype=torch.float32, device=dev)
    fsc_full[:n_rec // 2] = out.fsc
    shape = (n_data, n_data, n_data)
    return out._replace(
        volume=fourier_crop_3d(out.volume, shape),
        half1=fourier_crop_3d(out.half1, shape),
        half2=fourier_crop_3d(out.half2, shape),
        fsc=fsc_full,
        freqs=torch.arange(n_data // 2, dtype=torch.float32, device=dev)
        / n_data)


def _shaping_requested(params) -> bool:
    """True when any reconstruct-tab shaping window departs from its
    no-op default."""
    defaults = {
        "reconstruct_minazh": 0.0, "reconstruct_maxazh": 180.0,
        "reconstruct_mindef": 0.0, "reconstruct_maxdef": 100000.0,
        "reconstruct_minscore": 0.0, "reconstruct_maxscore": 1.0,
        "reconstruct_mintilt": -90.0, "reconstruct_maxtilt": 90.0,
        "reconstruct_firstframe": 0.0, "reconstruct_lastframe": -1.0,
        "reconstruct_score_fraction": 1.0,
    }
    for key, dv in defaults.items():
        v = params.get(key)
        if v not in (None, "") and float(v) != dv:
            return True
    return str(params.get("reconstruct_shapr") or "none") != "none"


def pixel_hint(table, params):
    return float(table["pixel_size"][0]) if "pixel_size" in table else float(
        params["scope_pixel"])


def check_ported(params: dict):
    """Raise NotImplementedError for an engine the port does not have;
    never switch to another engine silently."""
    engine = str(params.get("refine_engine") or "frm")
    if engine not in ("frm", "gather"):
        raise NotImplementedError(f"refine_engine={engine!r} is not ported; "
                                  "use -refine_engine frm or gather")


def _reference_mask(params, ref_volume, pixel, dev):
    """The refine_masking_method mask on `dev`: `auto` masks the reference
    by its own shape (postprocess.core.auto_mask), `file` reads the mask
    volume refine_maskth; spherical (the default) returns None, because the
    particle-side soft circle already does that job."""
    mm = str(params.get("refine_masking_method") or "spherical")
    if mm == "auto":
        return auto_mask(as_f32(ref_volume, dev), pixel_size=pixel)
    if mm == "file":
        return as_f32(mrc.read(str(params["refine_maskth"])), dev)
    return None


def gather_search_kwargs(params, iteration, pixel, global_search) -> dict:
    """The keyword arguments of `refine3d.refine_batch` at `iteration`
    (the gather engine's search and polish settings)."""
    rhref = float(param(params["refine_rhref"], iteration))
    return dict(
        angular_step=float(param(params["refine_dang"], iteration)),
        psi_step=float(params["refine_psi_step"]),
        low_res=float(params["refine_rlref"]),
        high_res_search=max(rhref, 2.5 * pixel),
        high_res_refine=max(rhref * 0.8, 2.1 * pixel),
        shift_extent=float(params["refine_searchx"]),
        shift_step=float(params.get("refine_shift_step") or 2.0),
        symmetry=str(params["particle_sym"]),
        mode="global" if global_search else "local",
        topk=int(params.get("refine_topk") or 4),
        local_iters=int(params.get("refine_local_iters") or 24),
        lr_angles=float(params.get("refine_lr_angles") or 2.0),
        lr_shifts=float(params.get("refine_lr_shifts") or 0.4),
        voltage_kv=float(params["scope_voltage"]),
        cs_mm=float(params["scope_cs"]),
        amplitude_contrast=float(params["scope_wgh"]),
    )


def _refine_gather(match_rows, table, ctf_params, ref_volume, params,
                   iteration, pixel, batch, global_search, shell_w, dev,
                   mesh=None):
    """Gather-engine poses for every row: refine3d.refine_batch per batch
    against the combined reference; with `mesh`, batches of `batch` rows
    per rank through parallel.sharded_refine_batch."""
    rb_kwargs = gather_search_kwargs(params, iteration, pixel, global_search)
    ref_dev = as_f32(ref_volume, dev)
    n_total = table.n_rows
    step = batch * (1 if mesh is None else mesh.size)
    results = []
    for lo in range(0, n_total, step):
        hi = min(lo + step, n_total)
        init = None if global_search else table_to_poses(table, pixel)[lo:hi]
        if mesh is not None:
            results.append(parallel.sharded_refine_batch(
                mesh, match_rows(slice(lo, hi)), ctf_params[lo:hi], ref_dev,
                pixel, init_poses=init, shell_weights=shell_w, **rb_kwargs))
            continue
        results.append(refine3d.refine_batch(
            match_rows(slice(lo, hi)), ctf_params[lo:hi], ref_dev, pixel,
            init_poses=init, shell_weights=shell_w, device=dev, **rb_kwargs))
    return refine3d.RefineResult(*(
        torch.cat([getattr(r, f) for r in results])
        for f in refine3d.RefineResult._fields))


def _refine_frm(match_rows, table, ctf_params, ref_volume, ref_halves,
                params, iteration, pixel, n_box, batch, global_search,
                fsc_curve, shell_w, dev, mesh=None):
    """FRM-engine poses for every row. One direction bank per reference
    (the combined map, or with the gold standard each half map), each
    half-set's rows matched in batches against their own bank; then, on
    the final iteration (refine_frm_polish), the gradient polish of
    refine3d.local_refine against the same reference, which removes the
    lattice quantization (~step/2) of the FRM directions. Each particle's
    result depends only on its own row, so routing rows by half gives what
    running every row through both banks and selecting would. With `mesh`
    each rank refines its contiguous range of the rows (against both
    banks) and the rows are gathered in rank order."""
    rhref = float(param(params["refine_rhref"], iteration))
    high_res = max(rhref * 0.8, 2.1 * pixel)
    searchx = float(params["refine_searchx"])
    # local iterations refine shifts around the table estimate (already
    # sub-pixel after the global iteration): +/-2 px
    se = searchx if global_search else min(searchx, 2.0)
    cfg = frm.get_config(
        n_box, pixel,
        low_res=float(params["refine_rlref"]),
        high_res=high_res,
        angular_step=float(param(params["refine_dang"], iteration)),
        symmetry=str(params["particle_sym"]),
        shift_extent=se,
        shift_step=float(params.get("refine_frm_shift_step") or 0)
        or max(0.5, searchx / 12.0),
        voltage_kv=float(params["scope_voltage"]),
        cs_mm=float(params["scope_cs"]),
        amplitude_contrast=float(params["scope_wgh"]),
        wiener=float(params.get("refine_frm_wiener") or 0.1),
        rounds=int(params.get("refine_frm_rounds") or 3),
        n_psi=int(params.get("refine_frm_npsi") or 0) or None,
        upsample=int(params.get("refine_frm_upsample") or 4),
        crop_margin=int(params.get("refine_frm_crop_margin") or 8),
        device=dev,
    )
    d_block = int(params.get("refine_frm_dblock") or 0) or None
    iblow = int(params.get("refine_iblow") or 2)
    n_total = table.n_rows
    gold = bool(params.get("refine_goldstandard")) and ref_halves is not None
    refs = tuple(ref_halves) if gold else (ref_volume,)
    halves = _half_subsets(table) if gold else np.zeros(n_total, np.int64)
    lo_r, hi_r = 0, n_total
    if mesh is not None:
        from pyp_tpu_torch.parallel.multihost import process_range

        lo_r, hi_r = (process_range(n_total, mesh.size, mesh.rank)
                      if mesh.active else (n_total, n_total))
    groups = [lo_r + np.nonzero(halves[lo_r:hi_r] == h)[0]
              for h in range(len(refs))]
    # pose priors restrict the local search to a cone around the current
    # pose; without priors the local mode searches the full lattice
    cone = (None if global_search or not params.get("refine_priors", True)
            else float(params.get("refine_frm_cone") or 20.0))
    poses_now = as_f32(table_to_poses(table, pixel), dev)
    all_poses = torch.zeros((n_total, 5), device=dev)
    all_scores = torch.zeros(n_total, device=dev)
    for rows_h, ref in zip(groups, refs):
        if not len(rows_h):
            continue
        bank = cfg.bank(volume_to_fourier(as_f32(ref, dev), pad=iblow))
        logger.info("FRM bank iter %d: D=%d R=%d n_psi=%d (%.2f GiB); "
                    "polar=%s; %d rows", iteration, *bank.FUc.shape,
                    bank.FUc.numel() * 8 / 2**30,
                    "gather" if cfg.polar_gather else "matmul", len(rows_h))
        for lo in range(0, len(rows_h), batch):
            rows = rows_h[lo:lo + batch]
            r_t = torch.as_tensor(rows, device=dev)
            poses, scores = frm.frm_refine(
                match_rows(rows), ctf_params[rows], None, cfg, bank=bank,
                init_poses=None if global_search else poses_now[r_t],
                prior_cone_deg=cone, fsc_curve=fsc_curve, d_block=d_block)
            all_poses[r_t] = poses
            all_scores[r_t] = scores
        bank = None  # free it before the next bank and the polish

    polish_when = str(params.get("refine_frm_polish") or "final")
    if polish_when == "always" or (
            polish_when == "final" and "refine_maxiter" in params
            and iteration >= int(params["refine_maxiter"]) + 1):
        polish_pts = as_f32(refine3d.make_mask_points(
            n_box, pixel, float(params["refine_rlref"]), high_res), dev)
        # cisTEM refine_mask order (psi, theta, phi, shx, shy) -> the pose
        # layout (phi, theta, psi, sy, sx)
        rm = [float(v) for v in str(params.get("refine_mask") or "1,1,1,1,1"
                                    ).replace(":", ",").split(",")]
        pose_mask = (rm[2], rm[1], rm[0], rm[4], rm[3])
        # polish activation memory grows with batch x band points
        pstep = max(64, batch // max(1, (n_box // 128) ** 2))
        for rows_h, ref in zip(groups, refs):
            if not len(rows_h):
                continue
            F = volume_to_fourier(as_f32(ref, dev), pad=iblow)
            for lo in range(0, len(rows_h), pstep):
                rows = rows_h[lo:lo + pstep]
                r_t = torch.as_tensor(rows, device=dev)
                p, sc = refine3d.local_refine(
                    match_rows(rows), as_f32(ctf_params[rows], dev), F,
                    all_poses[r_t], polish_pts, n_box, pixel,
                    voltage_kv=float(params["scope_voltage"]),
                    cs_mm=float(params["scope_cs"]),
                    amplitude_contrast=float(params["scope_wgh"]),
                    iters=int(params.get("refine_local_iters") or 24),
                    lr_angles=float(params.get("refine_lr_angles") or 2.0),
                    lr_shifts=float(params.get("refine_lr_shifts") or 0.4),
                    weights=shell_w, pose_mask=pose_mask)
                all_poses[r_t] = p
                all_scores[r_t] = sc
    if mesh is not None:
        all_poses, all_scores = parallel.spmd.gather_range(
            mesh, [all_poses[lo_r:hi_r], all_scores[lo_r:hi_r]], n_total)
    return frm.to_refine_result(all_poses, all_scores,
                                n_band_points=len(cfg.radii) * cfg.n_psi)


def refinement_iteration(
    stack, table: cistem.Table, ref_volume, params: dict, iteration: int,
    batch: int = 256, fsc_curve=None, ref_halves=None, prev_table=None,
    device="cuda",
):
    """One iteration on `device`: refine poses in batches of at most
    `batch` particles, then reconstruct half maps + FSC. `stack` is a
    numpy array or a tensor (either stays where it is; each batch moves to
    the device). Returns (table, Reconstruction, FSC resolution in Å).

    ref_halves: the previous iteration's (half1, half2) maps. With the FRM
    engine and refine_goldstandard, each half-set's particles align only
    against their own half map (its own bank and polish reference). The
    gather engine aligns every particle against the combined map, as the
    JAX package's gather engine does.

    prev_table: the table before the previous iteration's refinement, for
    the consistency test of reconstruct_shapr=consistency."""
    check_ported(params)
    dev = resolve_device(device)
    mesh = parallel.pipeline_mesh(params, dev)
    pixel = pixel_hint(table, params)
    rhref = float(param(params["refine_rhref"], iteration))
    mode = params.get("refine_mode", "local")
    if (fsc_curve is not None and params.get("refine_fboost")
            and float(params.get("refine_fboostlim") or 0.0) > 0):
        # signed-CC boost: shells coarser than fboostlim keep full weight
        n_sh = len(np.asarray(fsc_curve))
        sh_res = stack.shape[-1] * pixel / np.maximum(np.arange(n_sh), 1)
        fsc_curve = np.where(sh_res >= float(params["refine_fboostlim"]),
                             np.maximum(np.asarray(fsc_curve), 0.999),
                             np.asarray(fsc_curve))
    n_total = table.n_rows
    n_box = stack.shape[-1]
    ctf_params = table_to_ctf_params(table)
    has_poses = np.any(np.abs(table_to_poses(table, pixel)[:, :3]) > 1e-6)
    global_search = mode == "global" or not has_poses

    # outer mask radius (particle_rad, Å): matching sees the soft-masked
    # particle; reconstruction keeps the raw images
    rad_a = float(params.get("refine_maskrad") or 0.0) or float(
        params.get("particle_rad") or 0.0)
    if global_search and float(params.get("refine_srad") or 0.0) > 0:
        rad_a = float(params["refine_srad"])
    m2d = (soft_circular_mask(n_box, rad_a / pixel, 4.0, device=dev)
           if rad_a > 0 else None)

    # focused refinement: in local mode each particle's matching image is
    # masked to the projection of the focus sphere at its current pose
    focus = refine3d.parse_focus_mask(params.get("class_focusmask"))
    fmasks = None
    if focus is not None and not global_search:
        fmasks = refine3d.focus_mask_2d(
            as_f32(table_to_poses(table, pixel), dev), focus, n_box, pixel)

    def match_rows(rows):
        """Matching images of `rows` (a slice or an int array) on `dev`."""
        idx = rows if isinstance(rows, slice) else torch.as_tensor(rows)
        xs = as_f32(stack[rows if isinstance(stack, np.ndarray) else idx], dev)
        if m2d is not None:
            xs = xs * m2d[None]
        if fmasks is not None:
            xs = xs * fmasks[idx]
        return xs

    # reference masking ahead of matching (refine_masking_method), applied
    # to the reference and to both half maps
    m3 = _reference_mask(params, ref_volume, pixel, dev)
    if m3 is not None:
        ref_volume = as_f32(ref_volume, dev) * m3
        if ref_halves is not None:
            ref_halves = tuple(as_f32(h, dev) * m3 for h in ref_halves)

    shell_w = None
    if fsc_curve is not None and params.get("refine_fssnr", True):
        rhref_pts = refine3d.make_mask_points(
            n_box, pixel, float(params["refine_rlref"]),
            max(rhref * 0.8, 2.1 * pixel))
        shell_w = refine3d.shell_weights_from_fsc(fsc_curve, rhref_pts, n_box)
        rbfact = float(params.get("refine_rbfact") or 0.0)
        if rbfact > 0:
            # alignment-only B-factor envelope exp(-B g²/4) over the band
            g2 = np.sum(np.asarray(rhref_pts, dtype=np.float64) ** 2, axis=1)
            g2 = g2 / (n_box * pixel) ** 2
            shell_w = (shell_w * np.exp(-rbfact * g2 / 4.0)).astype(np.float32)

    engine = str(params.get("refine_engine") or "frm")
    if not params.get("refine_skip"):
        with Timer(f"refinement iteration {iteration}"):
            if engine == "frm":
                merged = _refine_frm(
                    match_rows, table, ctf_params, ref_volume, ref_halves,
                    params, iteration, pixel, n_box, batch, global_search,
                    fsc_curve, shell_w, dev, mesh)
            else:
                merged = _refine_gather(
                    match_rows, table, ctf_params, ref_volume, params,
                    iteration, pixel, batch, global_search, shell_w, dev,
                    mesh)
            table = poses_into_table(table, merged, pixel,
                                     freeze=_dof_freeze(params))

    with Timer(f"reconstruction iteration {iteration}"):
        poses = table_to_poses(table, pixel)
        if not params.get("reconstruct_per_particle_splitting", True) and \
                "particle_group" in table:
            # half-set split by micrograph: correlations within a
            # micrograph stay inside one half
            subset = np.asarray(table["particle_group"]).astype(int) % 2
        else:
            subset = (_half_subsets(table) if "assigned_subset" in table
                      else np.arange(n_total) % 2)
        weights = (np.asarray(table["occupancy"]) / 100.0
                   if "occupancy" in table else np.ones(n_total))
        # score-based particle weighting exp(bsc * z-score), capped
        bsc = float(params.get("refine_bsc") or 0.0)
        if bsc > 0 and "score" in table:
            sc = np.asarray(table["score"])
            glob = params.get("refine_global_stat",
                              params.get("metric_global_stat", True))
            if not glob and "particle_group" in table:
                grp = np.asarray(table["particle_group"]).astype(int)
                z = np.zeros_like(sc)
                for g in np.unique(grp):
                    m = grp == g
                    z[m] = (sc[m] - sc[m].mean()) / (sc[m].std() + 1e-6)
            else:
                z = (sc - sc.mean()) / (sc.std() + 1e-6)
            weights = weights * np.exp(np.clip(bsc * z, -4.0, 1.0))
        # FREALIGN PBC/BOFF weighting, capped at 1
        pbc = float(params.get("refine_pbc") or 0.0)
        if pbc > 0 and "score" in table:
            sc = np.asarray(table["score"])
            boff = float(params.get("refine_boff") or 0.0) or float(sc.mean())
            weights = weights * np.exp(
                np.clip(pbc * (sc - boff) / 100.0, -5.0, 0.0))
        # score threshold: particles under the percentile get weight 0
        thr_pct = float(params.get("reconstruct_score_threshold") or 0.0)
        if thr_pct > 0 and "score" in table:
            sc = np.asarray(table["score"])
            weights = np.where(sc >= np.percentile(sc, thr_pct), weights, 0.0)
        # score shaping: group-local cutoffs and the defocus / azimuth /
        # tilt / frame windows, folded into the weights (the table keeps
        # its alignment state)
        if _shaping_requested(params) and "score" in table:
            keep = scores.shaping_mask_from_params(table, params,
                                                   previous=prev_table)
            weights = np.where(keep, weights, 0.0)
        batch = int(params.get("reconstruct_batch") or batch)
        min_occ = float(params.get("reconstruct_min_occ") or 0.0)
        if min_occ > 0 and "occupancy" in table:
            weights = np.where(
                np.asarray(table["occupancy"]) >= min_occ, weights, 0.0)
        rc_kwargs = dict(
            subset=subset.astype(np.int32), weights=weights.astype(np.float32),
            symmetry=(str(params["particle_sym"])
                      if params.get("reconstruct_apply_symmetry", True)
                      else "C1"),
            voltage_kv=float(params["scope_voltage"]),
            cs_mm=float(params["scope_cs"]),
            amplitude_contrast=float(params["scope_wgh"]),
            wiener=float(params.get("reconstruct_wiener") or 0.5),
            batch=batch,
            pad=int(params.get("reconstruct_pad") or 2),
            gridding=str(params.get("reconstruct_gridding") or "trilinear"),
            iewald=int(params.get("reconstruct_iewald") or 0),
        )
        if abs(rc_kwargs["iewald"]) >= 2:
            # reference-based Ewald (IEWALD ±2): the current map predicts
            # the opposite sphere branch during insertion, its amplitude
            # fitted to each particle (insert_slices_halves)
            rc_kwargs["ref_volume"] = ref_volume
        if params.get("reconstruct_lblur"):
            # likelihood blurring: insert over a psi-offset bank
            rc_kwargs["lblur_range"] = float(
                params.get("reconstruct_lblur_range") or 20.0)
            step_deg = float(params.get("reconstruct_lblur_step") or 0.0)
            rc_kwargs["lblur_nrot"] = (
                max(3, int(round(rc_kwargs["lblur_range"] / step_deg)) | 1)
                if step_deg > 0
                else int(params.get("reconstruct_lblur_nrot") or 21))
        rec_stack = stack
        if params.get("reconstruct_norm"):
            # per-particle normalization ahead of insertion
            rec_stack = normalize_images(as_f32(stack, dev))
        # reconstruct_rrec: hard reconstruction resolution limit (Å); the
        # final iteration otherwise always reconstructs full-size
        rrec = float(params.get("reconstruct_rrec") or 0.0)
        is_final = ("refine_maxiter" in params
                    and iteration >= int(params["refine_maxiter"]) + 1)
        if rrec > 2.0 * pixel:
            out = reconstruct_banded(rec_stack, poses, ctf_params, pixel,
                                     rrec, rc_kwargs, device=dev, mesh=mesh)
        elif bool(params.get("reconstruct_crop", True)) and not is_final:
            try:  # cover this iteration's band, the next one's, and polish
                rhref_next = float(param(params["refine_rhref"], iteration + 1))
            except (ValueError, TypeError):
                rhref_next = rhref
            out = reconstruct_banded(
                rec_stack, poses, ctf_params, pixel,
                max(min(rhref, rhref_next) * 0.7, 2.0 * pixel),
                rc_kwargs, device=dev, mesh=mesh)
        else:
            out = _reconstruct(rec_stack, poses, ctf_params, pixel,
                               rc_kwargs, dev, mesh)
    res_a = float(fsc_mod.resolution_at_threshold(
        out.freqs, out.fsc, pixel,
        float(params.get("refine_fsc_threshold") or 0.143)))
    peak = (f"; device memory peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"
            if dev.type == "cuda" else "")
    logger.info("iteration %d: FSC(0.143) resolution %.2f Å%s", iteration,
                res_a, peak)
    return table, out, res_a


def _rotation_change_deg(prev_poses, now):
    Ra = euler_to_matrix(*(torch.as_tensor(prev_poses[:, i]) for i in range(3)))
    Rb = euler_to_matrix(*(torch.as_tensor(now[:, i]) for i in range(3)))
    tr = torch.einsum("bij,bij->b", Ra, Rb).numpy()
    return np.degrees(np.arccos(np.clip((tr - 1) / 2, -1, 1)))


def _map_stack(fn, stack, dev, batch: int = 1024):
    """fn applied on `dev` to each batch of a numpy stack; numpy float32
    result."""
    out = np.empty(stack.shape, dtype=np.float32)
    for lo in range(0, len(stack), batch):
        out[lo:lo + batch] = _np(fn(as_f32(stack[lo:lo + batch], dev)))
    return out


def _refine_defocus_table(stack, table, volume, params, it, pixel, dev):
    """Per-particle defocus refinement at the table's poses against
    `volume` (refine3d.refine_defocus in batches of reconstruct_batch);
    df1 and df2 move by the same offset, astigmatism stays."""
    rhref = float(param(params["refine_rhref"], it))
    n = stack.shape[-1]
    Fref = volume_to_fourier(as_f32(volume, dev))
    pts = as_f32(refine3d.make_mask_points(n, pixel, float(params["refine_rlref"]),
                                        max(rhref, 2.5 * pixel)), dev)
    cp_all = table_to_ctf_params(table)
    poses_all = table_to_poses(table, pixel)
    bsz = int(params.get("reconstruct_batch") or 256)
    new_df = []
    for lo in range(0, len(stack), bsz):
        hi = min(lo + bsz, len(stack))
        cp_b, _ = refine3d.refine_defocus(
            as_f32(stack[lo:hi], dev), as_f32(cp_all[lo:hi], dev), Fref,
            as_f32(poses_all[lo:hi], dev), pts, n, pixel,
            search_range=float(params.get("refine_def_range") or 500.0),
            n_steps=int(params.get("refine_def_steps") or 21),
            voltage_kv=float(params["scope_voltage"]),
            cs_mm=float(params["scope_cs"]),
            amplitude_contrast=float(params["scope_wgh"]))
        new_df.append(_np(cp_b[:, 0]))
    d_off = np.concatenate(new_df) - cp_all[:, 0]
    table["defocus_1"] = np.asarray(table["defocus_1"]) + d_off
    table["defocus_2"] = np.asarray(table["defocus_2"]) + d_off
    logger.info("defocus refinement: median |Δdf| %.1f Å",
                float(np.median(np.abs(d_off))))
    return table


def refine_loop(stack, table, initial_model, params, work_dir=".",
                dataset="dataset", cls: int = 1, device="cuda"):
    """Multi-iteration refinement on `device` with durable per-iteration
    state (maps/<dataset>_r{cls:02d}_{it:02d}.mrc/.cistem, half maps, FSC,
    history JSON), resuming after the latest finished iteration found in
    maps/ — whichever package wrote it. Returns (table, final map,
    history).

    With reconstruct_fbfact the final iteration also writes
    <stem>_<it>_sharp.mrc; with model_fit each iteration appends its PDB
    fit to maps/<dataset>_model_fit.txt (and `model_cc` to the history);
    with refine_fmatch the run ends by writing maps/<dataset>_match.mrc,
    the projections of the final map at the final poses.

    In a distributed group every rank runs the loop on the same inputs
    and rank 0 alone writes; the function returns on every rank once the
    files are written."""
    check_ported(params)
    dev = resolve_device(device)
    writer = parallel.is_writer()
    maps_dir = Path(work_dir) / "maps"
    if writer:
        maps_dir.mkdir(parents=True, exist_ok=True)
    pixel = float(params["scope_pixel"])
    start = int(params.get("refine_iter") or 2)
    maxiter = int(params["refine_maxiter"])
    ref = np.asarray(initial_model, dtype=np.float32)
    stem = f"{dataset}_r{cls:02d}"

    # resume: load the latest finished iteration's full durable state —
    # map + table + half maps (-> the FSC weighting the next iteration
    # would have seen) + prior history
    history = []
    fsc_curve = None
    ref_halves = None
    for it in range(maxiter + 1, start - 1, -1):
        m = maps_dir / f"{stem}_{it:02d}.mrc"
        t = maps_dir / f"{stem}_{it:02d}.cistem"
        if m.exists() and t.exists():
            ref = mrc.read(m).astype(np.float32)
            table = cistem.read_parameters(t)
            h1p = maps_dir / f"{stem}_{it:02d}_half1.mrc"
            h2p = maps_dir / f"{stem}_{it:02d}_half2.mrc"
            if h1p.exists() and h2p.exists():
                h1 = mrc.read(h1p).astype(np.float32)
                h2 = mrc.read(h2p).astype(np.float32)
                ref_halves = (h1, h2)
                _, curve = fsc_mod.fsc(torch.as_tensor(h1), torch.as_tensor(h2))
                fsc_curve = curve.numpy()
            hist_p = maps_dir / f"{stem}_history.json"
            if hist_p.exists():
                try:
                    history = [e for e in json.loads(hist_p.read_text())
                               if int(e.get("iteration", 0)) <= it]
                except ValueError:
                    history = []
            start = it + 1
            logger.info("resuming at iteration %d", start)
            break
    scope = dict(voltage_kv=float(params["scope_voltage"]),
                 cs_mm=float(params["scope_cs"]))
    bt0 = (float(params.get("scope_beam_tilt_x") or 0.0),
           float(params.get("scope_beam_tilt_y") or 0.0))
    if any(bt0):
        # calibrated microscope beam tilt: correct the working stack up
        # front; refine_beamtilt can still estimate the residual later
        stack = _map_stack(lambda x: refine3d.correct_beam_tilt(
            x, bt0[0], bt0[1], pixel, **scope), stack, dev)
        logger.info("applied calibrated beam tilt (%.3f, %.3f) mRad", *bt0)
    beam_tilt_done = False
    for it in range(start, maxiter + 2):
        if (maps_dir / "wait").exists():
            # interactive pause: a `wait` file in maps/ holds the loop
            # between iterations; remove it to resume
            logger.info("maps/wait present: pausing before iteration %d", it)
            while (maps_dir / "wait").exists():
                time.sleep(5.0)
            logger.info("maps/wait removed: resuming")
        prev_table = (table.copy()
                      if _shaping_requested(params) and "score" in table
                      else None)
        prev_poses = (table_to_poses(table, pixel)
                      if params.get("plot_per_item", True) else None)
        table, recon, res_a = refinement_iteration(
            stack, table, ref, params, it, fsc_curve=fsc_curve,
            ref_halves=ref_halves, prev_table=prev_table, device=dev)
        ref_halves = (recon.half1, recon.half2)
        if params.get("refine_beamtilt") and not beam_tilt_done and it > start:
            # one-shot dataset beam-tilt estimate once poses are warm
            rhref = float(param(params["refine_rhref"], it))
            tx, ty = refine3d.estimate_beam_tilt(
                as_f32(stack, dev), as_f32(table_to_ctf_params(table), dev),
                volume_to_fourier(recon.volume),
                as_f32(table_to_poses(table, pixel), dev), stack.shape[-1],
                pixel, amplitude_contrast=float(params["scope_wgh"]),
                low_res=float(params.get("refine_beamtilt_rlref") or 20.0),
                high_res=max(rhref, 2.5 * pixel,
                             float(params.get("refine_beamtilt_rhref")
                                   or 4.0)), **scope)
            tx, ty = float(tx), float(ty)
            stack = _map_stack(lambda x: refine3d.correct_beam_tilt(
                x, tx, ty, pixel, **scope), stack, dev)
            table["beam_tilt_x"] = np.full(table.n_rows, tx)
            table["beam_tilt_y"] = np.full(table.n_rows, ty)
            beam_tilt_done = True
            logger.info("beam tilt: (%.2e, %.2e) rad estimated and corrected",
                        tx, ty)
        if params.get("refine_fdef") and it > start:
            table = _refine_defocus_table(stack, table, recon.volume, params,
                                          it, pixel, dev)
        fsc_curve = _np(recon.fsc)
        ref = recon.volume
        if writer:
            mrc.write(_np(ref).astype(np.float32),
                      maps_dir / f"{stem}_{it:02d}.mrc", pixel_size=pixel)
            mrc.write(_np(recon.half1),
                      maps_dir / f"{stem}_{it:02d}_half1.mrc",
                      pixel_size=pixel)
            mrc.write(_np(recon.half2),
                      maps_dir / f"{stem}_{it:02d}_half2.mrc",
                      pixel_size=pixel)
            cistem.write_parameters(table,
                                    maps_dir / f"{stem}_{it:02d}.cistem")
        if params.get("reconstruct_fbfact") and it == maxiter + 1 and writer:
            # Guinier B over the refined band, applied negated to the final
            # map, written beside the unsharpened one
            bfac = guinier_bfactor(ref, pixel, max_res=max(res_a, 2.2 * pixel))
            sharp, _ = sharpen_map(ref, pixel, bfactor=-abs(bfac),
                                   resolution=res_a)
            mrc.write(_np(sharp).astype(np.float32),
                      maps_dir / f"{stem}_{it:02d}_sharp.mrc",
                      pixel_size=pixel)
            logger.info("fbfact: Guinier B %.1f Å² applied to final map",
                        bfac)
        if writer:
            np.savetxt(maps_dir / f"{stem}_{it:02d}_fsc.txt",
                       np.stack([_np(recon.freqs), _np(recon.fsc)], 1),
                       header="freq_cyc_per_px fsc")
        entry = {"iteration": it, "resolution": res_a}
        if prev_poses is not None:
            # per-iteration change statistics (+ histograms when matplotlib
            # is installed)
            now = table_to_poses(table, pixel)
            d_ang = _rotation_change_deg(prev_poses, now)
            d_sh = np.hypot(now[:, 3] - prev_poses[:, 3],
                            now[:, 4] - prev_poses[:, 4])
            sc = (np.asarray(table["score"]) if "score" in table
                  else np.zeros(table.n_rows))
            try:
                if writer:
                    plot_iteration_changes(
                        d_ang, d_sh, sc,
                        maps_dir / f"{stem}_{it:02d}_changes.png",
                        iteration=it)
            except (ImportError, ValueError, OSError) as e:
                logger.warning("iteration-change plot skipped: %s", e)
            entry["median_angular_change_deg"] = round(
                float(np.median(d_ang)), 3)
            entry["median_shift_change_px"] = round(float(np.median(d_sh)), 3)
        if "occupancy" in table:
            entry["occupancies"] = [round(
                float(np.mean(np.asarray(table["occupancy"]))), 2)]
        if params.get("model_fit"):
            _model_fit(params, ref, pixel, it, entry,
                       maps_dir / f"{dataset}_model_fit.txt", dev)
        history.append(entry)
        if not writer:
            continue
        (maps_dir / f"{stem}_history.json").write_text(json.dumps(history))
        web = Web()
        if web.exists:
            web.write_reconstruction(dataset, it, res_a,
                                     fsc=_np(recon.fsc).tolist())
    if params.get("refine_fmatch") and writer:
        # matching projections at the final poses (visual pose QC), in
        # batches of 512
        poses_f = table_to_poses(table, pixel)
        ref_dev = as_f32(ref, dev)
        match = [_np(project_real(ref_dev, poses_f[lo:lo + 512, 0],
                                  poses_f[lo:lo + 512, 1],
                                  poses_f[lo:lo + 512, 2]))
                 for lo in range(0, table.n_rows, 512)]
        mrc.write(np.concatenate(match).astype(np.float32),
                  maps_dir / f"{dataset}_match.mrc", pixel_size=pixel)
        logger.info("matching projections written to %s",
                    maps_dir / f"{dataset}_match.mrc")
    parallel.barrier()
    return table, ref, history


def _model_fit(params, ref, pixel, it, entry, out_path, dev):
    """Score the model_fit PDB against this iteration's map (prepared by
    model_pixel / model_scale / model_flip / model_clip): `model_cc` into
    the history entry, one "<it> <cc> <shift z y x>" line appended to
    out_path. An unreadable model is a warning, as in the JAX package."""
    from pyp_tpu_torch.analysis.modelfit import model_map_fit
    from pyp_tpu_torch.io.pdb import read_pdb

    try:
        rhref_fit = float(param(params["refine_rhref"], it))
        fit_map = as_f32(ref, dev)
        fit_pixel = float(params.get("model_pixel") or 0.0) or pixel
        if params.get("model_scale") not in (None, "", 0, 1, 1.0):
            fit_map = fit_map * float(params["model_scale"])
        if params.get("model_flip"):
            fit_map = fit_map.flip(0)
        clip = int(params.get("model_clip") or 0)
        if 0 < clip < fit_map.shape[-1]:
            lo = max(fit_map.shape[-1] // 2 - clip // 2, 0)
            fit_map = fit_map[lo:lo + clip, lo:lo + clip, lo:lo + clip]
        res_cap = float(params.get("model_res") or 0.0)
        fit = model_map_fit(
            read_pdb(str(params["model_fit"])), fit_map, fit_pixel,
            low_res=float(params.get("refine_rlref") or 100.0),
            high_res=max(rhref_fit, res_cap, 2.5 * fit_pixel),
            extra_bfactor_a2=float(params.get("model_fit_bfactor") or 100.0),
            device=dev)
        entry["model_cc"] = round(fit["cc"], 4)
        if not parallel.is_writer():
            return
        with open(out_path, "a") as f:
            f.write(f"{it} {fit['cc']:.4f} "
                    f"{' '.join(str(int(s)) for s in fit['shift_px'])}\n")
        logger.info("model fit (iter %d): cc %.3f shift %s", it, fit["cc"],
                    fit["shift_px"].tolist())
    except (OSError, ValueError) as e:
        logger.warning("model fit skipped: %s", e)


def _half_subsets(table) -> np.ndarray:
    """Half-set ids (0/1) from the table's 1-based assigned_subset column;
    rows with subset <= 0 get a deterministic even/odd assignment."""
    sub = np.asarray(table["assigned_subset"]).astype(np.int64) - 1
    fallback = np.arange(table.n_rows) % 2
    return np.where(sub < 0, fallback, sub)
