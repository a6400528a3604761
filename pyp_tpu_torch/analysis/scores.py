"""Score shaping and particle cleaning of particle tables — the torch
port of pyp_tpu/analysis/scores.py but `per_frame_weights`: the
reconstruction-time shaping path (per-(angular, defocus)-group score
cutoffs with adaptive window growth and NaN-aware smoothing, defocus /
azimuth / tilt / frame windows, score reversal and the between-iteration
consistency test, folded into a keep mask) and what the `clean` and
`kselection` modes call (`particle_cleaning`, `remove_duplicates`,
`generate_cluster_stacks`, `select_classes`, `expand_symmetry`). Table
logic runs in numpy, as in the JAX package; rotations go through torch."""

from __future__ import annotations

import numpy as np
import torch

from pyp_tpu_torch.core.geometry import euler_to_matrix
from pyp_tpu_torch.utils import get_logger

logger = get_logger("scores")


def score_threshold(scores, mode: str = "otsu", sigma: float = 1.0):
    """Pick a score cutoff: 'otsu' (bimodal split), 'sigma' (mean - k*std),
    or a float quantile in (0, 1)."""
    scores = np.asarray(scores, dtype=np.float64)
    if isinstance(mode, float) or (isinstance(mode, str) and mode.replace(".", "").isdigit()):
        return float(np.quantile(scores, float(mode)))
    if mode == "sigma":
        return float(scores.mean() - sigma * scores.std())
    # otsu on a 128-bin histogram
    hist, edges = np.histogram(scores, bins=128)
    centers = 0.5 * (edges[:-1] + edges[1:])
    total = hist.sum()
    best_lo = best_hi = centers[0]
    best_var = -1.0
    w0 = 0.0
    sum0 = 0.0
    sum_all = (hist * centers).sum()
    for i in range(128):
        w0 += hist[i]
        if w0 == 0 or w0 == total:
            continue
        sum0 += hist[i] * centers[i]
        m0 = sum0 / w0
        m1 = (sum_all - sum0) / (total - w0)
        var = w0 * (total - w0) * (m0 - m1) ** 2
        if var > best_var + 1e-9:
            best_var, best_lo, best_hi = var, centers[i], centers[i]
        elif abs(var - best_var) <= 1e-9:
            # flat maximum (empty gap between well-separated modes): the
            # robust cut is the plateau midpoint, not its first bin
            best_hi = centers[i]
    return float(0.5 * (best_lo + best_hi))


def angular_groups(phi, theta, n_groups: int = 50):
    """Group particles by viewing direction: each particle's viewing axis
    is assigned to the nearest of n_groups Fibonacci-sphere seeds."""
    R = euler_to_matrix(torch.as_tensor(np.asarray(phi, dtype=np.float32)),
                        torch.as_tensor(np.asarray(theta, dtype=np.float32)),
                        0.0).numpy()
    views = R[:, 2, :]  # viewing axes
    k = n_groups
    idx = np.arange(k) + 0.5
    ga = np.pi * (1 + 5**0.5) * idx
    z = 1 - 2 * idx / k
    r = np.sqrt(1 - z * z)
    seeds = np.stack([r * np.cos(ga), r * np.sin(ga), z], axis=1)
    return np.argmax(views @ seeds.T, axis=1)


def _smooth_grid_nan(grid, sigma: float = 1.0):
    """NaN-aware Gaussian smoothing of the per-group threshold grid (the
    nextPYP smooths its thresholds with gaussian_filter(sigma=1),
    analysis/scores.py:560): normalized convolution where NaN cells carry
    zero weight, so sparse groups inherit their neighbours' cutoffs."""
    grid = np.asarray(grid, dtype=np.float64)
    if sigma <= 0:
        return grid
    r = max(1, int(round(3 * sigma)))
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    valid = np.isfinite(grid)
    filled = np.where(valid, grid, 0.0)

    def conv1(a, axis):
        pad = [(0, 0), (0, 0)]
        pad[axis] = (r, r)
        ap = np.pad(a, pad)
        out = np.zeros_like(a)
        for i, w in enumerate(k):
            sl = [slice(None), slice(None)]
            sl[axis] = slice(i, i + a.shape[axis])
            out += w * ap[tuple(sl)]
        return out

    num = conv1(conv1(filled, 0), 1)
    den = conv1(conv1(valid.astype(np.float64), 0), 1)
    with np.errstate(invalid="ignore", divide="ignore"):
        sm = num / den
    return np.where(den > 0, sm, np.nan)


def group_thresholds(scores, ang_g, def_g, n_angles: int, n_defocuses: int,
                     threshold: float, pind=None, tilt_angles=None,
                     min_group: int = 100, min_score=None, max_score=None,
                     smooth_sigma: float = 1.0, low_tilt: float = 12.0):
    """Per-(angular, defocus)-group cutoffs with adaptive window growth
    (nextPYP's shape_phase_residuals): each group's window expands
    until it holds >= min_group samples; threshold==0 picks the optimal
    bimodal split (1.075 x Otsu, groups under 20 points get no cut);
    0<threshold<1 keeps that fraction of best scores. For tomo tables
    (pind + tilt_angles given) the statistic is the per-particle mean score
    over low-tilt projections (|tilt| <= low_tilt), matching nextPYP's
    groupby("pind") path. The grid is NaN-aware Gaussian smoothed before
    use. Returns (thresholds, min_grid, max_grid), each (n_angles,
    n_defocuses); NaN = no cut for that group."""
    scores = np.asarray(scores, dtype=np.float64)
    thr = np.full((n_angles, n_defocuses), np.nan)
    mn = np.full((n_angles, n_defocuses), np.nan)
    mx = np.full((n_angles, n_defocuses), np.nan)
    is_tomo = pind is not None and tilt_angles is not None
    if is_tomo:
        pind = np.asarray(pind).astype(int)
        tilt_angles = np.asarray(tilt_angles, dtype=np.float64)
    for g in range(n_angles):
        for f in range(n_defocuses):
            cluster = (ang_g == g) & (def_g == f)
            if not cluster.any():
                # empty cells stay NaN: their threshold is never consumed,
                # and letting a grown-window estimate leak into the
                # smoothing would pull populated neighbours' cutoffs toward
                # unrelated view families
                continue
            size = 1
            # grow the window until the statistics are meaningful
            while cluster.sum() < min_group and len(scores) > min_group:
                cluster = ((ang_g >= g - size) & (ang_g <= g + size)
                           & (def_g >= f - size) & (def_g <= f + size))
                size += 1
            if not cluster.any():
                continue
            prs = scores[cluster]
            if is_tomo:
                sel = cluster & (np.abs(tilt_angles) <= low_tilt)
                if sel.any():
                    ids = pind[sel]
                    order = np.argsort(ids, kind="stable")
                    uniq, starts = np.unique(ids[order], return_index=True)
                    sums = np.add.reduceat(scores[sel][order], starts)
                    counts = np.diff(np.append(starts, len(ids)))
                    stat = sums / counts
                else:
                    stat = prs
            else:
                stat = prs
            if threshold == 0:
                # optimal bimodal split (nextPYP: 1.075 x optimal)
                if stat.size > 20:
                    thr[g, f] = 1.075 * score_threshold(stat, "otsu")
            elif 0 < threshold < 1:
                thr[g, f] = np.sort(stat)[
                    int((stat.size - 1) * (1.0 - threshold))]
            elif threshold > 1:
                # absolute count of best-scoring images to keep
                keep_n = int(min(threshold, stat.size))
                thr[g, f] = np.sort(stat)[stat.size - keep_n]
            # relative score windows: fractions of the group's score range
            if min_score is not None:
                mn[g, f] = (prs.min() + min_score * (prs.max() - prs.min())
                            if min_score < 1 else min_score)
            if max_score is not None:
                mx[g, f] = (prs.max() - (1 - max_score) * (prs.max() - prs.min())
                            if max_score <= 1 else max_score)
    return _smooth_grid_nan(thr, smooth_sigma), mn, mx


def consistency_keep(table, previous, threshold: float = 0.9):
    """Keep particles whose orientation/shift changed consistently with the
    population between iterations (nextPYP's shape_phase_residuals
    `consistency` branch, analysis/scores.py:700-740): the angle jump vs the
    previous table (mod 360) and the differential shift are each thresholded
    at their `threshold` percentile. Returns a boolean keep mask."""
    phi_now = np.asarray(table["phi"], dtype=np.float64)
    phi_prev = np.asarray(previous["phi"], dtype=np.float64)
    anglejumps = np.mod(np.abs(phi_now - phi_prev), 360.0)
    sx = np.asarray(table["x_shift"], dtype=np.float64) - \
        np.asarray(previous["x_shift"], dtype=np.float64)
    sy = np.asarray(table["y_shift"], dtype=np.float64) - \
        np.asarray(previous["y_shift"], dtype=np.float64)
    shiftjumps = np.hypot(sx, sy)
    n = len(anglejumps)
    q = min(int((n - 1) * threshold), n - 1)
    max_angle = np.sort(anglejumps)[q]
    max_shift = np.sort(shiftjumps)[q]
    keep = (anglejumps <= max_angle) & (shiftjumps <= max_shift)
    logger.info("consistency selection: kept %d/%d (angle jump <= %.2f deg, "
                "shift jump <= %.2f)", int(keep.sum()), n, max_angle, max_shift)
    return keep


def min_projections_keep(pind, active, min_projections: int):
    """Deactivate every projection of particles left with fewer than
    `min_projections` active projections (nextPYP's
    clean.min_num_projections): per-particle count over the active mask."""
    pind = np.asarray(pind).astype(int)
    active = np.asarray(active).astype(bool)
    ids, inv = np.unique(pind, return_inverse=True)
    counts = np.bincount(inv, weights=active.astype(np.float64))
    return counts[inv] >= min_projections


def assign_angular_defocus_groups(table, n_angles: int = 25,
                                  n_defocuses: int = 25):
    """Partition particles into (angular, defocus) bins (nextPYP's
    assign_angular_defocus_groups, analysis/scores.py:208): theta is binned
    modulo 180 into `n_angles` groups; defocus_1 is min-max binned into
    `n_defocuses` groups. Returns (angular_group (B,), defocus_group (B,))."""
    theta = np.asarray(table["theta"], dtype=np.float64)
    df1 = np.asarray(table["defocus_1"], dtype=np.float64)
    angular = np.floor(np.mod(theta, 180.0) * n_angles / 180.0).astype(int)
    angular = np.clip(angular, 0, n_angles - 1)
    lo, hi = float(np.floor(df1.min())), float(np.ceil(df1.max()))
    if hi == lo:
        defocus = np.zeros(len(df1), dtype=int)
    else:
        defocus = np.round((df1 - lo) / (hi - lo) * (n_defocuses - 1)).astype(int)
    return angular, defocus


def shape_scores(
    table,
    n_angles: int = 25,
    n_defocuses: int = 25,
    threshold: float = 1.0,
    min_defocus: float = None,
    max_defocus: float = None,
    min_score: float = None,
    max_score: float = None,
    reverse: bool = False,
    tilt_angles=None,
    min_tilt: float = None,
    max_tilt: float = None,
    min_azh: float = None,
    max_azh: float = None,
    first_frame: int = None,
    last_frame: int = None,
    previous=None,
    consistency: bool = False,
    odd: bool = False,
    even: bool = False,
    min_group: int = 100,
    smooth_sigma: float = 1.0,
):
    """Per-(angular, defocus)-group score shaping — the behaviour of
    nextPYP's shape_phase_residuals:

    * group-local cutoffs (adaptive window growth, bimodal auto threshold
      at threshold==0, percentile at 0<threshold<1, absolute count above 1)
      prevent views/defoci with systematically lower scores from being
      purged wholesale; the cutoff grid is NaN-aware Gaussian smoothed;
    * tomo tables (a `tind` column + `tilt_angles`) cut whole particles by
      their low-tilt mean score;
    * per-group relative score windows (min/max as fractions of the group
      range), absolute defocus window, azimuth window on mod(theta, 180)
      (top/side view shaping), exposure window on the frame/tilt index
      column, and a tilt-angle window;
    * `reverse` flips score polarity before thresholding; `consistency`
      (with `previous`) drops particles with outlier angle/shift jumps
      between iterations; `odd`/`even` zero alternating rows for
      half-set reconstructions.

    Rejected rows get occupancy 0 (and image_is_active 0). Returns (table,
    keep mask)."""
    scores = np.asarray(table["score"], dtype=np.float64)
    if reverse:
        fin = np.isfinite(scores)
        if fin.any():
            lo, hi = scores[fin].min(), scores[fin].max()
            scores = np.where(fin, hi - scores + lo, scores)
    df1 = np.asarray(table["defocus_1"], dtype=np.float64)
    ang_g, def_g = assign_angular_defocus_groups(table, n_angles, n_defocuses)
    keep = np.ones(len(scores), dtype=bool)

    is_tomo = tilt_angles is not None and "particle_index" in table
    pind = (np.asarray(table["particle_index"]).astype(int)
            if is_tomo else None)
    if threshold != 1.0 or min_score is not None or max_score is not None:
        thr, mn, mx = group_thresholds(
            scores, ang_g, def_g, n_angles, n_defocuses, threshold,
            pind=pind, tilt_angles=tilt_angles, min_group=min_group,
            min_score=min_score, max_score=max_score,
            smooth_sigma=smooth_sigma)
        cut = thr[ang_g, def_g]
        has_cut = np.isfinite(cut)
        if is_tomo:
            # per-particle low-tilt mean score decides the whole particle
            ta = np.asarray(tilt_angles, dtype=np.float64)
            low = np.abs(ta) <= 12.0
            ids, inv = np.unique(pind, return_inverse=True)
            wsum = np.bincount(inv, weights=np.where(low, scores, 0.0))
            wcnt = np.bincount(inv, weights=low.astype(np.float64))
            with np.errstate(invalid="ignore", divide="ignore"):
                pmean = wsum / wcnt
            pmean = np.where(wcnt > 0, pmean,
                             np.bincount(inv, weights=scores)
                             / np.bincount(inv))
            keep &= ~(has_cut & (pmean[inv] < np.where(has_cut, cut, -np.inf)))
        else:
            keep &= ~(has_cut & (scores < np.where(has_cut, cut, -np.inf)))
        lo_g = mn[ang_g, def_g]
        hi_g = mx[ang_g, def_g]
        keep &= ~(np.isfinite(lo_g) & (scores < np.where(
            np.isfinite(lo_g), lo_g, -np.inf)))
        keep &= ~(np.isfinite(hi_g) & (scores > np.where(
            np.isfinite(hi_g), hi_g, np.inf)))
    if min_defocus is not None:
        keep &= df1 >= min_defocus
    if max_defocus is not None:
        keep &= df1 <= max_defocus
    if min_azh is not None or max_azh is not None:
        azh = np.mod(np.asarray(table["theta"], dtype=np.float64), 180.0)
        if min_azh is not None and min_azh > 0:
            keep &= azh >= min_azh
        if max_azh is not None and max_azh < 180:
            keep &= azh <= max_azh
    if (first_frame is not None or (last_frame is not None
                                    and last_frame > -1)) and "tilt_index" in table:
        tind = np.asarray(table["tilt_index"]).astype(int)
        if first_frame is not None:
            keep &= tind >= first_frame
        if last_frame is not None and last_frame > -1:
            keep &= tind <= last_frame
    if tilt_angles is not None and (min_tilt is not None
                                    or max_tilt is not None):
        ta = np.asarray(tilt_angles, dtype=np.float64)
        if min_tilt is not None:
            keep &= ta >= min_tilt
        if max_tilt is not None:
            keep &= ta <= max_tilt
    if consistency and previous is not None:
        keep &= consistency_keep(
            table, previous,
            threshold if 0 < threshold < 1 else 0.9)
    if odd:
        keep[::2] = False
    if even:
        keep[1::2] = False

    if "occupancy" in table:
        occ = np.asarray(table["occupancy"]).copy()
        occ[~keep] = 0.0
        table["occupancy"] = occ
    if "image_is_active" in table:
        active = np.asarray(table["image_is_active"]).copy()
        active[~keep] = 0
        table["image_is_active"] = active
    logger.info("score shaping: kept %d/%d particles "
                "(%d angular x %d defocus groups)",
                int(keep.sum()), len(keep), n_angles, n_defocuses)
    return table, keep


def shaping_mask_from_params(table, params, tilt_angles=None, previous=None):
    """Reconstruction-time score shaping driven by the reconstruct-tab
    parameters (reconstruct_minazh/maxazh, mindef/maxdef,
    minscore/maxscore, mintilt/maxtilt, firstframe/lastframe, shapr in
    {none, reverse, consistency}; nextPYP applies them ahead of every
    reconstruction). Returns a boolean keep mask — the
    table is NOT mutated (the caller folds the mask into reconstruction
    weights so shaping never destroys alignment state)."""
    def fv(key, default):
        v = params.get(key)
        return default if v in (None, "") else float(v)

    if tilt_angles is None and "tilt_angle" in table:
        ta = np.asarray(table["tilt_angle"], dtype=np.float64)
        if np.any(ta != 0):
            tilt_angles = ta
    shapr = str(params.get("reconstruct_shapr") or "none")
    minscore = fv("reconstruct_minscore", 0.0)
    maxscore = fv("reconstruct_maxscore", 1.0)
    shadow = table.copy()
    _, keep = shape_scores(
        shadow,
        n_angles=int(fv("clean_shape_angles", 25)),
        n_defocuses=int(fv("clean_shape_defocuses", 25)),
        threshold=fv("reconstruct_score_fraction", 1.0),
        min_defocus=fv("reconstruct_mindef", 0.0) or None,
        max_defocus=(fv("reconstruct_maxdef", 100000.0)
                     if fv("reconstruct_maxdef", 100000.0) < 100000.0
                     else None),
        min_score=minscore if minscore > 0 else None,
        max_score=maxscore if maxscore != 1.0 else None,
        reverse=shapr == "reverse",
        tilt_angles=tilt_angles,
        min_tilt=(fv("reconstruct_mintilt", -90.0)
                  if fv("reconstruct_mintilt", -90.0) > -90.0 else None),
        max_tilt=(fv("reconstruct_maxtilt", 90.0)
                  if fv("reconstruct_maxtilt", 90.0) < 90.0 else None),
        min_azh=fv("reconstruct_minazh", 0.0) or None,
        max_azh=(fv("reconstruct_maxazh", 180.0)
                 if fv("reconstruct_maxazh", 180.0) < 180.0 else None),
        first_frame=int(fv("reconstruct_firstframe", 0)) or None,
        last_frame=int(fv("reconstruct_lastframe", -1)),
        previous=previous,
        consistency=shapr == "consistency" and previous is not None,
    )
    return keep


def particle_cleaning(table, score_cut=None, min_occ: float = 0.0,
                      mode: str = "otsu"):
    """Deactivate particles below the score threshold or the occupancy
    floor. Returns (table, kept mask); rows stay in the table (FREALIGN
    semantics: OCC 0 and image_is_active 0 instead of deletion)."""
    scores = np.asarray(table["score"], dtype=np.float64)
    if score_cut is None:
        score_cut = score_threshold(scores, mode)
    keep = scores >= score_cut
    if "occupancy" in table:
        keep &= np.asarray(table["occupancy"]) >= min_occ
    if "image_is_active" in table:
        table["image_is_active"] = keep.astype(np.int64)
    if "occupancy" in table:
        occ = np.asarray(table["occupancy"]).copy()
        occ[~keep] = 0.0
        table["occupancy"] = occ
    logger.info("particle cleaning: %d/%d kept (cutoff %.2f)",
                int(keep.sum()), len(keep), score_cut)
    return table, keep


def remove_duplicates(positions, scores, min_distance: float):
    """Greedy NMS on (N, 2 or 3) positions: keep the best-scoring particle
    within each min_distance neighbourhood. Returns a boolean keep mask."""
    positions = np.asarray(positions, dtype=np.float64)
    order = np.argsort(np.asarray(scores))[::-1]
    keep = np.zeros(len(positions), dtype=bool)
    kept_pos = []
    for i in order:
        p = positions[i]
        if all(np.linalg.norm(p - q) >= min_distance for q in kept_pos):
            keep[i] = True
            kept_pos.append(p)
    return keep


def select_classes(table, keep_classes):
    """Keep only particles assigned (best_2d_class) to the given classes:
    deactivates everything else. Returns (table, keep mask)."""
    assign = np.asarray(table["best_2d_class"]).astype(int)
    keep = np.isin(assign, np.asarray(list(keep_classes), dtype=int))
    if "image_is_active" in table:
        table["image_is_active"] = keep.astype(np.int64)
    if "occupancy" in table:
        occ = np.asarray(table["occupancy"]).copy()
        occ[~keep] = 0.0
        table["occupancy"] = occ
    logger.info("class selection: %d/%d particles kept (classes %s)",
                int(keep.sum()), len(keep), sorted(keep_classes))
    return table, keep


def generate_cluster_stacks(stack, table, n_angles: int = 25,
                            n_defocuses: int = 25, out_dir=".",
                            base: str = "cluster"):
    """Per-(angular, defocus)-group particle stacks for visual inspection:
    each populated group's particles, sorted by score, written as
    <base>_<g>_<f>_stack.mrc; the group means go into one stack
    <base>_means.mrc. Returns the list of written stack paths."""
    from pathlib import Path

    from pyp_tpu_torch.io import mrc

    stack = np.asarray(stack)
    ang_g, def_g = assign_angular_defocus_groups(table, n_angles, n_defocuses)
    scores = (np.asarray(table["score"], dtype=np.float64)
              if "score" in table else np.zeros(len(ang_g)))
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    written, means = [], []
    for g in range(n_angles):
        for f in range(n_defocuses):
            idx = np.nonzero((ang_g == g) & (def_g == f))[0]
            if idx.size == 0:
                continue
            idx = idx[np.argsort(scores[idx])]
            path = out_dir / f"{base}_{g}_{f}_stack.mrc"
            mrc.write(stack[idx].astype(np.float32), path)
            written.append(str(path))
            means.append(stack[idx].mean(axis=0))
    if means:
        mrc.write(np.stack(means).astype(np.float32),
                  out_dir / f"{base}_means.mrc")
    logger.info("cluster stacks: %d populated groups written to %s",
                len(written), out_dir)
    return written


def expand_symmetry(table, symmetry: str):
    """Symmetry-expand a particle table: every particle is replicated once
    per point-group rotation S_k with orientation R @ S_k (Euler angles by
    matrix_to_euler), mates grouped by rotation; the other columns copy
    through and the occupancy is divided by the group order."""
    from pyp_tpu_torch.core.geometry import (apply_symmetry_matrices,
                                             matrix_to_euler)
    from pyp_tpu_torch.io import cistem

    mats = apply_symmetry_matrices(symmetry)
    K = len(mats)
    n = table.n_rows
    R = euler_to_matrix(
        *(torch.as_tensor(np.asarray(table[k], np.float32))
          for k in ("phi", "theta", "psi"))).numpy()          # (n, 3, 3)
    out = cistem.Table.zeros(n * K)
    for name in table.data:
        out[name] = np.tile(np.asarray(table[name]), K)
    phis, thetas, psis = [], [], []
    for S in mats:
        Rk = np.einsum("nij,jk->nik", R, S)
        ph, th, ps = matrix_to_euler(torch.as_tensor(Rk, dtype=torch.float32))
        phis.append(ph.numpy())
        thetas.append(th.numpy())
        psis.append(ps.numpy())
    out["phi"] = np.concatenate(phis)
    out["theta"] = np.concatenate(thetas)
    out["psi"] = np.concatenate(psis)
    if "occupancy" in table:
        out["occupancy"] = np.tile(np.asarray(table["occupancy"]) / K, K)
    return out
