"""Multi-reference (K-class) 3D refinement with occupancy updates — the
torch port of pyp_tpu/pipeline/classify3d.py.

Each iteration refines every particle against every class reference (the
FRM engine by default, one bank per class; `refine_engine gather` polishes
locally; with `class_focusmask` and consensus poses, a fixed-pose masked
NCC inside the projected focus sphere), converts the per-class scores to
soft occupancies (softmax with a mixing-proportion prior,
`analysis.occupancies`), and reconstructs each class from
occupancy-weighted particles. Maps, tables and the history are the files
the JAX package writes (maps/<dataset>_rKK_II.mrc,
maps/<dataset>_classes_II.cistem), so a classification resumes across the
two packages. The stack is uploaded once and stays on the device.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from pyp_tpu_torch import as_f32, resolve_device
from pyp_tpu_torch.analysis import occupancies as occ_mod
from pyp_tpu_torch.config.params import param
from pyp_tpu_torch.core import fsc as fsc_mod
from pyp_tpu_torch.core.geometry import euler_to_matrix
from pyp_tpu_torch.io import cistem, mrc
from pyp_tpu_torch.ops import frm, refine3d
from pyp_tpu_torch.ops import reconstruct as rec
from pyp_tpu_torch.ops.fourier_slice import (fourier_to_image,
                                             image_to_fourier, project,
                                             volume_to_fourier)
from pyp_tpu_torch.pipeline.refine import (_half_subsets, _np,
                                           poses_into_table,
                                           reconstruct_banded,
                                           table_to_ctf_params,
                                           table_to_poses)
from pyp_tpu_torch.utils import Timer, get_logger

logger = get_logger("classify3d")

_FIELDS = refine3d.RefineResult._fields


def _concat(parts):
    return refine3d.RefineResult(*(
        np.concatenate([_np(getattr(r, f)) for r in parts]) for f in _FIELDS))


def classify3d_iteration(
    stack, table: cistem.Table, references, occ, params: dict, iteration: int,
    batch: int = 256, device="cuda",
):
    """One K-class iteration on `device`. references: list of (n, n, n);
    occ: (B, K) in percent; stack: numpy or a tensor (uploaded once).

    Returns (table, new references, new occ, per-class resolutions)."""
    dev = resolve_device(device)
    stack = as_f32(stack, dev)
    K = len(references)
    B = table.n_rows
    pixel = float(table["pixel_size"][0]) if "pixel_size" in table else float(
        params["scope_pixel"])
    rhref = float(param(params["refine_rhref"], iteration))
    ctf_params = table_to_ctf_params(table)
    ctf_t = as_f32(ctf_params, dev)
    init_poses = table_to_poses(table, pixel)

    engine = str(params.get("refine_engine") or "frm")
    # focused classification (class_focusmask "x,y,z,r" in Å): classes
    # share the consensus density outside the sphere, so only the focus
    # region drives the per-class scores; reconstruction keeps the raw
    # classes
    fm = str(params.get("class_focusmask") or "").strip()
    score_refs = [np.asarray(r, dtype=np.float32) for r in references]
    if fm and K > 1:
        fx, fy, fz, fr = (float(v) for v in fm.replace(",", ":").split(":"))
        n_box = score_refs[0].shape[-1]
        ax = np.arange(n_box) - n_box // 2
        r2 = ((ax[:, None, None] - fz / pixel) ** 2
              + (ax[None, :, None] - fy / pixel) ** 2
              + (ax[None, None, :] - fx / pixel) ** 2)
        t = (np.sqrt(r2) - fr / pixel) / 4.0
        sph = (1.0 - np.clip(t, 0.0, 1.0)).astype(np.float32)
        consensus = np.mean(np.stack(score_refs), axis=0)
        score_refs = [consensus * (1 - sph) + r * sph for r in score_refs]
    focus = refine3d.parse_focus_mask(fm) if K > 1 else None
    has_poses = bool(np.any(np.abs(init_poses[:, :3]) > 1e-6))
    focused_scoring = focus is not None and has_poses
    per_class = []
    if focused_scoring:
        # focused E-step: poses stay at the consensus; per-class scores
        # are masked NCCs inside the projected focus sphere
        with Timer(f"focused classification iteration {iteration} "
                   f"({K} classes)"):
            per_class = _focused_class_scores(
                stack, init_poses, ctf_params, score_refs, focus, pixel,
                params, batch=batch, device=dev)
    with Timer(f"classification iteration {iteration} ({K} classes)"):
        if focused_scoring:
            pass  # scored above at fixed poses
        elif engine == "frm":
            n_box = stack.shape[-1]
            cfg = frm.get_config(
                n_box, pixel,
                low_res=float(params["refine_rlref"]),
                high_res=max(float(params.get("class_rhcls") or rhref),
                             2.1 * pixel),
                angular_step=float(param(
                    params.get("refine_dang") or 15.0, iteration)),
                symmetry=str(params["particle_sym"]),
                shift_extent=float(params.get("refine_searchx") or 6.0),
                shift_step=1.0,
                voltage_kv=float(params["scope_voltage"]),
                cs_mm=float(params["scope_cs"]),
                amplitude_contrast=float(params["scope_wgh"]),
                wiener=float(params.get("refine_frm_wiener") or 0.1),
                device=dev,
            )
            cone = (float(params.get("refine_frm_cone") or 20.0)
                    if has_poses else None)
            G_pts = len(cfg.radii) * cfg.n_psi
            for k in range(K):
                bank = cfg.bank(volume_to_fourier(as_f32(score_refs[k], dev)))
                parts = []
                for lo in range(0, B, batch):
                    hi = min(lo + batch, B)
                    poses_k, scores_k = frm.frm_refine(
                        stack[lo:hi], ctf_t[lo:hi], None, cfg, bank=bank,
                        init_poses=init_poses[lo:hi] if has_poses else None,
                        prior_cone_deg=cone)
                    parts.append(frm.to_refine_result(
                        poses_k, scores_k, n_band_points=G_pts))
                per_class.append(_concat(parts))
                del bank
        else:
            for k in range(K):
                parts = []
                for lo in range(0, B, batch):
                    hi = min(lo + batch, B)
                    parts.append(refine3d.refine_batch(
                        stack[lo:hi], ctf_t[lo:hi], score_refs[k], pixel,
                        mode="local", init_poses=init_poses[lo:hi],
                        low_res=float(params["refine_rlref"]),
                        high_res_refine=max(
                            float(params.get("class_rhcls") or rhref),
                            2.1 * pixel),
                        local_iters=int(params.get("refine_local_iters") or 16),
                        symmetry=str(params["particle_sym"]),
                        voltage_kv=float(params["scope_voltage"]),
                        cs_mm=float(params["scope_cs"]),
                        amplitude_contrast=float(params["scope_wgh"]),
                        device=dev))
                per_class.append(_concat(parts))

    # occupancies from per-class log-likelihood proxies
    logp = np.stack([_np(r.logp) for r in per_class], axis=1)   # (B, K)
    prior = occ_mod.update_average_occupancies(occ)
    occ = occ_mod.occupancies_from_logp(
        logp, prior_occ=prior,
        temperature=float(params.get("class3d_tau") or 1.0))
    # occupancy floor: no class dies in one bad iteration
    floor = float(params.get("class3d_occ_floor") or 0.0)
    if floor > 0:
        occ = np.maximum(occ, floor)
        occ = occ / occ.sum(axis=1, keepdims=True) * 100.0
    assign = occ_mod.hard_assignments(occ)

    # each particle keeps the pose refined against its best class: one
    # fancy index per field
    rows = np.arange(B)
    best = refine3d.RefineResult(*(
        np.stack([_np(getattr(r, f)) for r in per_class])[assign, rows]
        for f in _FIELDS))
    table = poses_into_table(table, best, pixel)
    table["occupancy"] = occ[rows, assign]
    table["best_2d_class"] = assign + 1

    # per-class reconstruction (the classmerge jobs)
    poses = table_to_poses(table, pixel)
    subset = (_half_subsets(table) if "assigned_subset" in table
              else np.arange(B) % 2)
    new_refs, resolutions = [], []
    for k in range(K):
        # band-limited per-class maps: classification matches only up to
        # class_rhcls, and the class axis multiplies the insertion cost
        out = reconstruct_banded(
            stack, poses, ctf_params, pixel,
            (max(float(params.get("class_rhcls") or rhref) * 0.8, 2.0 * pixel)
             if bool(params.get("reconstruct_crop", True)) else 2.0 * pixel),
            dict(
                subset=subset.astype(np.int32),
                weights=(occ[:, k] / 100.0).astype(np.float32),
                symmetry=str(params["particle_sym"]),
                voltage_kv=float(params["scope_voltage"]),
                cs_mm=float(params["scope_cs"]),
                amplitude_contrast=float(params["scope_wgh"]),
                batch=batch,
                iewald=int(params.get("reconstruct_iewald") or 0),
            ),
            device=dev,
        )
        new_refs.append(_np(out.volume).astype(np.float32))
        resolutions.append(float(fsc_mod.resolution_at_threshold(
            _np(out.freqs), _np(out.fsc), pixel, 0.143)))
    logger.info("iteration %d: class occupancies %s, resolutions %s",
                iteration, np.round(prior, 1).tolist(),
                np.round(resolutions, 2).tolist())
    return table, new_refs, occ, resolutions


def _focused_class_scores(stack, init_poses, ctf_params, score_refs, focus,
                          pixel, params, batch: int = 256, device="cuda"):
    """Fixed-pose focused per-class scoring: particles are Fourier-centred
    by their stored shifts, each class reference is projected with its CTF
    at the consensus pose, and both are cut to the projection of the focus
    sphere (refine3d.focus_mask_2d) before a masked NCC in the
    classification band (class_rlcls..class_rhcls). LogP uses the mask
    area as the effective sample count. Returns a list of RefineResult
    (numpy fields, poses unchanged)."""
    dev = resolve_device(device)
    stack = as_f32(stack, dev)
    n = stack.shape[-1]
    B = len(stack)
    Frefs = [volume_to_fourier(as_f32(r, dev)) for r in score_refs]
    lo_res = float(params.get("class_rlcls") or params.get("refine_rlref")
                   or 100.0)
    hi_res = max(float(params.get("class_rhcls") or 8.0), 2.1 * pixel)
    ky = np.fft.fftfreq(n) * n
    kx = np.arange(n // 2 + 1)
    kr = np.sqrt(ky[:, None] ** 2 + kx[None, :] ** 2)
    r_lo = n * pixel / lo_res
    r_hi = n * pixel / hi_res
    band = as_f32(((kr >= r_lo) & (kr <= r_hi)).astype(np.float32), dev)
    # masks in the centred frame (shifts zeroed: the images are centred,
    # so the mask follows only the pose rotation)
    poses = np.asarray(init_poses, dtype=np.float32)
    poses_c = poses.copy()
    poses_c[:, 3:5] = 0.0
    poses_t = as_f32(poses, dev)
    poses_ct = as_f32(poses_c, dev)
    ctf_t = as_f32(ctf_params, dev)
    kw = (float(params["scope_voltage"]), float(params["scope_cs"]),
          float(params["scope_wgh"]))

    def score(xs, cp, poses_b, Fref, masks):
        Xc = rec._shift_correct(image_to_fourier(xs), poses_b[:, 3:5], n)
        imgs_c = fourier_to_image(Xc * band, n)
        R = euler_to_matrix(poses_b[:, 0], poses_b[:, 1], poses_b[:, 2])
        ctfs = rec._ctf_grids(n, pixel, cp, *kw)
        proj = fourier_to_image(project(Fref, R, n) * ctfs * band, n)
        xm = imgs_c * masks
        pm = proj * masks
        area = masks.sum(dim=(1, 2)) + 1e-6
        xm = xm - (xm.sum(dim=(1, 2)) / area)[:, None, None] * masks
        pm = pm - (pm.sum(dim=(1, 2)) / area)[:, None, None] * masks
        num = (xm * pm).sum(dim=(1, 2))
        den = (torch.sqrt((xm * xm).sum(dim=(1, 2)))
               * torch.sqrt((pm * pm).sum(dim=(1, 2))) + 1e-9)
        return num / den, area

    out = []
    for Fref in Frefs:
        sc_parts, ar_parts = [], []
        for lo in range(0, B, batch):
            hi = min(lo + batch, B)
            masks = refine3d.focus_mask_2d(poses_ct[lo:hi], focus, n, pixel)
            s, a = score(stack[lo:hi], ctf_t[lo:hi], poses_t[lo:hi], Fref,
                         masks)
            sc_parts.append(_np(s))
            ar_parts.append(_np(a))
        scores = np.clip(np.concatenate(sc_parts), -1.0, 1.0)
        area = np.concatenate(ar_parts)
        sigma = np.sqrt(np.maximum(1.0 - scores ** 2, 1e-6))
        logp = -0.5 * area * np.log(np.maximum(sigma, 1e-6))
        out.append(refine3d.RefineResult(
            phi=np.mod(poses[:, 0], 360.0), theta=np.mod(poses[:, 1], 360.0),
            psi=np.mod(poses[:, 2], 360.0), shift_y=poses[:, 3],
            shift_x=poses[:, 4], score=scores * 100.0, logp=logp,
            sigma=sigma))
    return out


def classify3d_loop(stack, table, initial_model, params, work_dir=".",
                    dataset="dataset", device="cuda"):
    """K-class classification on `device`: seed the classes by
    occupancy-jittered weighted reconstructions at the consensus poses
    (or, without poses, by noise-jittered copies of the initial model),
    iterate refinement / occupancy / reconstruction, and write the
    per-class maps (maps/<dataset>_rKK_II.mrc), the classes table per
    iteration, the history and the occupancy plot."""
    dev = resolve_device(device)
    K = int(params.get("class_num") or 1)
    B = table.n_rows
    maps_dir = Path(work_dir) / "maps"
    maps_dir.mkdir(parents=True, exist_ok=True)
    pixel = float(params["scope_pixel"])
    maxiter = int(params.get("class3d_iters") or 0) or \
        int(params["refine_maxiter"])
    start = int(params.get("refine_iter") or 2)
    stack = as_f32(stack, dev)

    # resume: a previous classification table restores occupancies and
    # assignments unless class3d_force_init discards them
    occ = None
    if not params.get("class3d_force_init"):
        prev = sorted(maps_dir.glob(f"{dataset}_classes_*.cistem"))
        if prev:
            t_prev = cistem.read_parameters(prev[-1])
            if (t_prev.n_rows == B and "occupancy" in t_prev
                    and "best_2d_class" in t_prev):
                assign = np.clip(np.asarray(
                    t_prev["best_2d_class"]).astype(int) - 1, 0, K - 1)
                o = np.asarray(t_prev["occupancy"], dtype=np.float64)
                occ = np.full((B, K), 1.0)
                occ[np.arange(B), assign] = np.maximum(o, 1.0)
                occ = occ / occ.sum(axis=1, keepdims=True) * 100.0
                logger.info("resuming classification from %s", prev[-1].name)
    if occ is None:
        occ = occ_mod.classification_initialization(B, K, seed=0)
    # seed class references with occupancy-jittered weighted
    # reconstructions: each seed leans toward a random particle subset, so
    # the seeds differ where the underlying states differ
    init_poses = table_to_poses(table, pixel)
    if np.any(np.abs(init_poses[:, :3]) > 1e-6):
        ctf_params = table_to_ctf_params(table)
        refs = []
        for k in range(K):
            out = rec.reconstruct(
                stack, init_poses, ctf_params, pixel,
                weights=(occ[:, k] / 100.0).astype(np.float32),
                symmetry=str(params["particle_sym"]),
                voltage_kv=float(params["scope_voltage"]),
                cs_mm=float(params["scope_cs"]),
                amplitude_contrast=float(params["scope_wgh"]),
                iewald=int(params.get("reconstruct_iewald") or 0),
                device=dev,
            )
            refs.append(_np(out.volume).astype(np.float32))
    else:  # no consensus alignment: jittered copies of the initial model
        rng = np.random.RandomState(1)
        r0 = np.asarray(initial_model, dtype=np.float32)
        refs = [r0 + rng.normal(0, 0.02 * (np.abs(r0).max() + 1e-6),
                                r0.shape).astype(np.float32)
                for _ in range(K)]

    history = []
    for it in range(start, maxiter + 2):
        table, refs, occ, resolutions = classify3d_iteration(
            stack, table, refs, occ, params, it, device=dev)
        for k, r in enumerate(refs):
            mrc.write(r, maps_dir / f"{dataset}_r{k + 1:02d}_{it:02d}.mrc",
                      pixel_size=pixel)
        cistem.write_parameters(table, maps_dir / f"{dataset}_classes_{it:02d}.cistem")
        history.append({
            "iteration": it, "resolutions": resolutions,
            "occupancy": occ.mean(axis=0).tolist(),
        })
    if params.get("plot_per_item", True) and history:
        try:
            from pyp_tpu_torch.analysis.plots import plot_occupancy_history

            plot_occupancy_history(
                history, maps_dir / f"{dataset}_occupancy.png")
        except (ImportError, OSError, ValueError) as e:
            logger.warning("occupancy plot skipped: %s", e)
        (maps_dir / f"{dataset}_history.json").write_text(
            json.dumps(history))
    return table, refs, occ, history
