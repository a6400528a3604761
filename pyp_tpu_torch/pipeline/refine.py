"""Iterative 3D refinement loop — the torch port of pyp_tpu/pipeline/refine.py
for the gather engine (`refine_engine=gather`).

Per iteration: pose refinement over particle batches (global search plus
local gradient polish, or local polish alone once the table has poses),
reconstruction of half maps, FSC/resolution bookkeeping, and durable state
(maps/<dataset>_r01_02.mrc, half maps, .cistem table, FSC text, history
JSON) in the same files the JAX package writes, so `refine_iter` resumes a
run started by either package.

Not ported yet (each raises NotImplementedError when requested): the FRM
engine, per-particle defocus refinement (refine_fdef), beam tilt
(refine_beamtilt, scope_beam_tilt_x/y), the final B-factor sharpening
(reconstruct_fbfact), model fitting (model_fit), matching projections
(refine_fmatch), score shaping, reference masking other than spherical,
likelihood blurring (reconstruct_lblur) and Ewald-sphere insertion
(reconstruct_iewald). There is no silent switch to another engine.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from pyp_tpu.config.params import param
from pyp_tpu.io import cistem, mrc
from pyp_tpu.stream.web import Web
from pyp_tpu.utils import Timer, get_logger
from pyp_tpu_torch import resolve_device
from pyp_tpu_torch.core import fsc as fsc_mod
from pyp_tpu_torch.core.fft import fourier_crop_3d
from pyp_tpu_torch.core.filters import normalize_images, soft_circular_mask
from pyp_tpu_torch.core.geometry import euler_to_matrix
from pyp_tpu_torch.ops import reconstruct as rec
from pyp_tpu_torch.ops import refine3d

logger = get_logger("refine")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _on(x, dev):
    """float32 tensor on `dev` from a numpy array or a tensor."""
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return x.to(device=dev, dtype=torch.float32)


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


def reconstruct_banded(stack, poses, ctf_params, pixel, high_res, rc_kwargs,
                       device="cpu"):
    """Reconstruction on the band-limited auto-crop grid, Fourier-padded
    back to the data box with the FSC remapped shell-for-shell onto the data
    axis. An intermediate map only needs fidelity to the matching band
    `high_res`, so cropping cuts the insertion work by (n_rec/n)^2."""
    n_data = int(stack.shape[-1])
    r_max = n_data * pixel / max(high_res, 2.0 * pixel)
    n_rec = min(n_data, int(np.ceil((2.0 * r_max + 8.0) / 16.0)) * 16)
    if n_rec >= 0.9 * n_data:  # negligible saving: skip crop+upsample
        return rec.reconstruct(stack, poses, ctf_params, pixel,
                               device=device, **rc_kwargs)
    out = rec.reconstruct(stack, poses, ctf_params, pixel, crop_to=n_rec,
                          device=device, **rc_kwargs)
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
    """Raise NotImplementedError for every requested feature the port does
    not have yet; never switch to another engine silently."""
    engine = str(params.get("refine_engine") or "frm")
    if engine == "frm":
        raise NotImplementedError(
            "FRM engine is ported in a later PR; use -refine_engine gather")
    if engine != "gather":
        raise NotImplementedError(f"refine_engine={engine!r} is not ported; "
                                  "use -refine_engine gather")
    unported = [
        ("refine_fdef", "per-particle defocus refinement (refine_fdef)"),
        ("refine_beamtilt", "beam-tilt refinement (refine_beamtilt)"),
        ("scope_beam_tilt_x", "beam-tilt correction (scope_beam_tilt_x)"),
        ("scope_beam_tilt_y", "beam-tilt correction (scope_beam_tilt_y)"),
        ("reconstruct_fbfact", "B-factor sharpening (reconstruct_fbfact)"),
        ("model_fit", "model fitting (model_fit)"),
        ("refine_fmatch", "matching projections (refine_fmatch)"),
        ("reconstruct_lblur", "likelihood blurring (reconstruct_lblur)"),
        ("reconstruct_iewald", "Ewald-sphere insertion (reconstruct_iewald)"),
    ]
    for key, what in unported:
        v = params.get(key)
        if v not in (None, "", 0, 0.0, False):
            raise NotImplementedError(f"{what} is ported in a later PR")
    if _shaping_requested(params):
        raise NotImplementedError("score shaping (reconstruct_min*/max*, "
                                  "reconstruct_shapr) is ported in a later PR")
    mm = str(params.get("refine_masking_method") or "spherical")
    if mm != "spherical":
        raise NotImplementedError(f"refine_masking_method={mm!r} is ported "
                                  "in a later PR; use spherical")


def refinement_iteration(
    stack, table: cistem.Table, ref_volume, params: dict, iteration: int,
    batch: int = 256, fsc_curve=None, device="cpu",
):
    """One iteration on `device`: refine poses in batches of at most
    `batch` particles, then reconstruct half maps + FSC. `stack` is a
    numpy array or a tensor (either stays where it is; each batch moves to
    the device). Returns (table, Reconstruction, FSC resolution in Å).

    The gather engine aligns every particle against the combined map, as
    the JAX package's gather engine does, so the previous half maps are
    not an input."""
    check_ported(params)
    dev = resolve_device(device)
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
            _on(table_to_poses(table, pixel), dev), focus, n_box, pixel)

    def match_batch(lo, hi):
        xs = _on(stack[lo:hi], dev)
        if m2d is not None:
            xs = xs * m2d[None]
        if fmasks is not None:
            xs = xs * fmasks[lo:hi]
        return xs

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

    dang = float(param(params["refine_dang"], iteration))
    rb_kwargs = dict(
        angular_step=dang,
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

    if not params.get("refine_skip"):
        with Timer(f"refinement iteration {iteration}"):
            ref_dev = _on(ref_volume, dev)
            results = []
            for lo in range(0, n_total, batch):
                hi = min(lo + batch, n_total)
                init = (None if global_search
                        else table_to_poses(table, pixel)[lo:hi])
                results.append(refine3d.refine_batch(
                    match_batch(lo, hi), ctf_params[lo:hi], ref_dev, pixel,
                    init_poses=init, shell_weights=shell_w, device=dev,
                    **rb_kwargs))
            merged = refine3d.RefineResult(*(
                torch.cat([getattr(r, f) for r in results])
                for f in refine3d.RefineResult._fields))
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
        )
        rec_stack = stack
        if params.get("reconstruct_norm"):
            # per-particle normalization ahead of insertion
            rec_stack = normalize_images(_on(stack, dev))
        # reconstruct_rrec: hard reconstruction resolution limit (Å); the
        # final iteration otherwise always reconstructs full-size
        rrec = float(params.get("reconstruct_rrec") or 0.0)
        is_final = ("refine_maxiter" in params
                    and iteration >= int(params["refine_maxiter"]) + 1)
        if rrec > 2.0 * pixel:
            out = reconstruct_banded(rec_stack, poses, ctf_params, pixel,
                                     rrec, rc_kwargs, device=dev)
        elif bool(params.get("reconstruct_crop", True)) and not is_final:
            try:  # cover this iteration's band, the next one's, and polish
                rhref_next = float(param(params["refine_rhref"], iteration + 1))
            except (ValueError, TypeError):
                rhref_next = rhref
            out = reconstruct_banded(
                rec_stack, poses, ctf_params, pixel,
                max(min(rhref, rhref_next) * 0.7, 2.0 * pixel),
                rc_kwargs, device=dev)
        else:
            out = rec.reconstruct(rec_stack, poses, ctf_params, pixel,
                                  device=dev, **rc_kwargs)
    res_a = float(fsc_mod.resolution_at_threshold(
        out.freqs, out.fsc, pixel,
        float(params.get("refine_fsc_threshold") or 0.143)))
    peak = (f"; device memory peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"
            if dev.type == "cuda" else "")
    logger.info("iteration %d: FSC(0.143) resolution %.2f Å%s", iteration,
                res_a, peak)
    return table, out, res_a


def _plot_iteration_changes(d_angles, d_shifts, scores, out_path, iteration):
    """Angular-change, shift-change and score histograms of one iteration."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(10.5, 2.8))
    axes[0].hist(d_angles, bins=40, color="tab:blue")
    axes[0].set_xlabel("angular change (°)")
    axes[0].set_ylabel("particles")
    axes[1].hist(d_shifts, bins=40, color="tab:orange")
    axes[1].set_xlabel("shift change (px)")
    axes[2].hist(scores, bins=40, color="tab:green")
    axes[2].set_xlabel("score")
    fig.suptitle(f"iteration {iteration}", fontsize=10)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def _rotation_change_deg(prev_poses, now):
    Ra = euler_to_matrix(*(torch.as_tensor(prev_poses[:, i]) for i in range(3)))
    Rb = euler_to_matrix(*(torch.as_tensor(now[:, i]) for i in range(3)))
    tr = torch.einsum("bij,bij->b", Ra, Rb).numpy()
    return np.degrees(np.arccos(np.clip((tr - 1) / 2, -1, 1)))


def refine_loop(stack, table, initial_model, params, work_dir=".",
                dataset="dataset", cls: int = 1, device="cpu"):
    """Multi-iteration refinement on `device` with durable per-iteration
    state (maps/<dataset>_r{cls:02d}_{it:02d}.mrc/.cistem, half maps, FSC,
    history JSON), resuming after the latest finished iteration found in
    maps/ — whichever package wrote it. Returns (table, final map,
    history)."""
    check_ported(params)
    dev = resolve_device(device)
    maps_dir = Path(work_dir) / "maps"
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
    for it in range(start, maxiter + 2):
        if (maps_dir / "wait").exists():
            # interactive pause: a `wait` file in maps/ holds the loop
            # between iterations; remove it to resume
            logger.info("maps/wait present: pausing before iteration %d", it)
            while (maps_dir / "wait").exists():
                time.sleep(5.0)
            logger.info("maps/wait removed: resuming")
        prev_poses = (table_to_poses(table, pixel)
                      if params.get("plot_per_item", True) else None)
        table, recon, res_a = refinement_iteration(
            stack, table, ref, params, it, fsc_curve=fsc_curve, device=dev)
        fsc_curve = _np(recon.fsc)
        ref = recon.volume
        mrc.write(_np(ref).astype(np.float32), maps_dir / f"{stem}_{it:02d}.mrc",
                  pixel_size=pixel)
        mrc.write(_np(recon.half1), maps_dir / f"{stem}_{it:02d}_half1.mrc",
                  pixel_size=pixel)
        mrc.write(_np(recon.half2), maps_dir / f"{stem}_{it:02d}_half2.mrc",
                  pixel_size=pixel)
        cistem.write_parameters(table, maps_dir / f"{stem}_{it:02d}.cistem")
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
                _plot_iteration_changes(
                    d_ang, d_sh, sc, maps_dir / f"{stem}_{it:02d}_changes.png",
                    iteration=it)
            except (ImportError, ValueError, OSError) as e:
                logger.warning("iteration-change plot skipped: %s", e)
            entry["median_angular_change_deg"] = round(
                float(np.median(d_ang)), 3)
            entry["median_shift_change_px"] = round(float(np.median(d_sh)), 3)
        if "occupancy" in table:
            entry["occupancies"] = [round(
                float(np.mean(np.asarray(table["occupancy"]))), 2)]
        history.append(entry)
        (maps_dir / f"{stem}_history.json").write_text(json.dumps(history))
        web = Web()
        if web.exists:
            web.write_reconstruction(dataset, it, res_a,
                                     fsc=_np(recon.fsc).tolist())
    return table, ref, history


def _half_subsets(table) -> np.ndarray:
    """Half-set ids (0/1) from the table's 1-based assigned_subset column;
    rows with subset <= 0 get a deterministic even/odd assignment."""
    sub = np.asarray(table["assigned_subset"]).astype(np.int64) - 1
    fallback = np.arange(table.n_rows) % 2
    return np.where(sub < 0, fallback, sub)
