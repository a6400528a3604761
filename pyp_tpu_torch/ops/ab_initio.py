"""Ab initio initial model generation — the torch port of
pyp_tpu/ops/ab_initio.py.

Two engines, as in the JAX package:
  * `ab_initio_frm` (the production engine): each round scores every
    particle against every lattice direction (ops/frm), turns the scores
    into a tempered posterior over its top-T directions and reconstructs
    with each particle inserted at all T, weighted; then a few hard FRM
    rounds on a finer lattice and a gradient polish (refine3d.local_refine);
  * `ab_initio` (classic): stochastic refinement of random subsets with the
    gather engine's global search (whose score runs through the
    shift_scored_match kernel on a card) down a resolution ladder.

Host randomness is `np.random.RandomState(seed)`, drawn in the JAX code's
order, so both packages start from the same poses and subsets. The stack
is uploaded once; reconstructions index it on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from pyp_tpu_torch import as_f32, resolve_device, rows_per_call
from pyp_tpu_torch.core.filters import lowpass_filter_3d, soft_spherical_mask
from pyp_tpu_torch.ops import frm, refine3d
from pyp_tpu_torch.ops import reconstruct as rec
from pyp_tpu_torch.ops.fourier_slice import volume_to_fourier
from pyp_tpu_torch.utils import Timer, get_logger

logger = get_logger("ab_initio")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _masked_lowpass(volume, mask, pixel_size, res):
    return _np(lowpass_filter_3d(volume * mask, pixel_size, float(res))
               ).astype(np.float32)


def ab_initio(
    stack,
    ctf_params,
    pixel_size: float,
    n_rounds: int = 6,
    start_res: float = 40.0,
    end_res: float = 12.0,
    subset_frac: float = 0.5,
    symmetry: str = "C1",
    angular_step: float = 20.0,
    seed: int = 0,
    voltage_kv: float = 300.0,
    cs_mm: float = 2.7,
    amplitude_contrast: float = 0.07,
    anneal: float = 0.0,
    device="cuda",
):
    """Returns (volume (n, n, n), final poses (B, 5)), numpy.

    Resolution ladder: geometric from start_res to end_res over rounds;
    each round refines a random subset globally (refine3d.refine_batch in
    global mode) and reconstructs from all particles (unassigned ones keep
    their random round-0 poses)."""
    dev = resolve_device(device)
    stack_np = np.asarray(stack, dtype=np.float32)
    B, n, _ = stack_np.shape
    stack_t = as_f32(stack_np, dev)
    ctf_np = np.asarray(ctf_params, dtype=np.float32)
    ctf_t = as_f32(ctf_np, dev)
    rng = np.random.RandomState(seed)

    poses = np.stack([
        rng.uniform(0, 360, B),
        np.degrees(np.arccos(rng.uniform(-1, 1, B))),
        rng.uniform(0, 360, B),
        np.zeros(B), np.zeros(B),
    ], axis=1).astype(np.float32)

    mask = soft_spherical_mask(n, n * 0.4, 4.0, device=dev)
    res_ladder = np.geomspace(start_res, end_res, n_rounds)
    kw = dict(voltage_kv=voltage_kv, cs_mm=cs_mm,
              amplitude_contrast=amplitude_contrast)

    def reconstruct_from(idx, poses, res):
        i_t = torch.as_tensor(idx, device=dev)
        out = rec.reconstruct(stack_t[i_t], poses[idx], ctf_t[i_t],
                              pixel_size, symmetry=symmetry,
                              batch=min(256, len(idx)), device=dev, **kw)
        return _masked_lowpass(out.volume, mask, pixel_size, res)

    # symmetry breaking: a few particles at random poses give a lumpy,
    # asymmetric start (a full random-pose map is nearly centrosymmetric)
    seed_idx = rng.choice(B, size=min(8, B), replace=False)
    vol = reconstruct_from(seed_idx, poses, res_ladder[0])
    all_idx = np.arange(B)

    for r in range(n_rounds):
        res = float(res_ladder[r])
        k = max(8, int(B * subset_frac))
        sel = rng.choice(B, size=k, replace=False)
        with Timer(f"ab-initio round {r + 1}/{n_rounds} @ {res:.0f} Å"):
            s_t = torch.as_tensor(sel, device=dev)
            out = refine3d.refine_batch(
                stack_t[s_t], ctf_t[s_t], vol, pixel_size,
                angular_step=angular_step, psi_step=angular_step,
                low_res=300.0, high_res_search=res, high_res_refine=res,
                shift_extent=max(2.0, n * 0.05), shift_step=2.0,
                symmetry=symmetry, mode="global", topk=2, local_iters=10,
                device=dev, **kw)
            poses[sel] = np.stack([_np(out.phi), _np(out.theta),
                                   _np(out.psi), _np(out.shift_y),
                                   _np(out.shift_x)], axis=1)
            if anneal > 0 and r < n_rounds - 1:
                # decaying angular noise keeps the assignments from
                # collapsing onto a bad seed
                frac = 1.0 - r / max(n_rounds - 1, 1)
                poses[:, :3] += rng.normal(0, anneal * frac, poses[:, :3].shape)
            vol = reconstruct_from(all_idx, poses, res)
    return vol, poses


def ab_initio_frm(
    stack,
    ctf_params,
    pixel_size: float,
    n_rounds: int = 10,
    start_res: float = 40.0,
    end_res: float = 12.0,
    symmetry: str = "C1",
    angular_step: float = 15.0,
    top_t: int = 8,
    beta0: float = 20.0,
    beta_growth: float = 1.4,
    hard_rounds: int = 3,
    hard_end_res: float = None,
    polish_rounds: int = 2,
    seed: int = 0,
    voltage_kv: float = 300.0,
    cs_mm: float = 2.7,
    amplitude_contrast: float = 0.07,
    soft_shifts: str = "zero",
    seed_particles: int = 8,
    random_skip_ratio: float = 0.0,
    device="cuda",
):
    """Marginalized ab initio on the FRM engine: each round scores every
    particle against every direction of the lattice, converts the scores
    to a tempered posterior over each particle's top-T directions (inverse
    temperature beta, growing by beta_growth a round) and reconstructs
    with every particle inserted at its T directions weighted by it; then
    hard FRM rounds on a finer lattice and `polish_rounds` gradient
    polishes. soft_shifts: "zero" scores centred picks, "marginalize"
    maximizes each score over the coarse shift grid, "track" also centres
    the grid on a running estimate. Returns (volume, hard poses (B, 5)),
    numpy."""
    dev = resolve_device(device)
    stack_np = np.asarray(stack, dtype=np.float32)
    ctf_np = np.asarray(ctf_params, dtype=np.float32)
    B, n, _ = stack_np.shape
    stack_t = as_f32(stack_np, dev)
    ctf_t = as_f32(ctf_np, dev)
    rng = np.random.RandomState(seed)
    mask = soft_spherical_mask(n, n * 0.4, 4.0, device=dev)
    res_ladder = np.geomspace(start_res, end_res, n_rounds)
    kw = dict(voltage_kv=voltage_kv, cs_mm=cs_mm,
              amplitude_contrast=amplitude_contrast)

    # lumpy asymmetric seed: a few particles at random poses
    seed_idx = rng.choice(B, size=min(max(int(seed_particles), 1), B),
                          replace=False)
    poses0 = np.stack([
        rng.uniform(0, 360, len(seed_idx)),
        np.degrees(np.arccos(rng.uniform(-1, 1, len(seed_idx)))),
        rng.uniform(0, 360, len(seed_idx)),
        np.zeros(len(seed_idx)), np.zeros(len(seed_idx)),
    ], axis=1).astype(np.float32)
    i_t = torch.as_tensor(seed_idx, device=dev)
    out = rec.reconstruct(stack_t[i_t], poses0, ctf_t[i_t], pixel_size,
                          symmetry=symmetry, device=dev, **kw)
    vol = _masked_lowpass(out.volume, mask, pixel_size, res_ladder[0])

    subset = np.arange(B) % 2
    beta = beta0
    poses_hard = None
    cur_shifts = np.zeros((B, 2), dtype=np.float32)
    for r in range(n_rounds):
        res = float(res_ladder[r])
        cfg = frm.get_config(
            n, pixel_size, low_res=min(300.0, n * pixel_size),
            high_res=max(res, 2.5 * pixel_size),
            angular_step=angular_step, symmetry=symmetry,
            # 1-px marginalization steps: 2-px steps leave the posterior
            # too decorrelated to lock
            shift_extent=max(2.0, n * 0.05), shift_step=1.0, device=dev,
            **kw)
        with Timer(f"ab-initio(frm) round {r + 1}/{n_rounds} @ {res:.0f} Å "
                   f"(beta={beta:.0f})"):
            bank = cfg.bank(volume_to_fourier(as_f32(vol, dev)))
            track = soft_shifts == "track"
            marg = track or soft_shifts == "marginalize"
            scores, psis, sh_bd = frm.frm_score_directions(
                stack_t, ctf_t, cfg, bank,
                shifts=(cur_shifts if track else None),
                marginalize_shifts=marg)
            # the top-T selection stays on the host in numpy, as in the
            # JAX package (argpartition's order decides the row order)
            scores = _np(scores)
            psis = _np(psis)
            D = scores.shape[1]
            T = min(top_t, D)
            top = np.argpartition(-scores, T - 1, axis=1)[:, :T]   # (B, T)
            s_top = np.take_along_axis(scores, top, axis=1)
            p_top = np.take_along_axis(psis, top, axis=1)
            w = np.exp(beta * (s_top - s_top.max(axis=1, keepdims=True)))
            w /= w.sum(axis=1, keepdims=True)
            dirs = bank.directions[top]                   # (B, T, 2)
            if marg:
                sh_top = np.take_along_axis(_np(sh_bd), top[..., None], axis=1)
            else:
                sh_top = np.zeros((B, T, 2), np.float32)
            poses_soft = np.concatenate([
                dirs, p_top[..., None], sh_top,
            ], axis=2).reshape(B * T, 5).astype(np.float32)
            rows = np.repeat(np.arange(B), T)
            w_round = w.copy()
            if random_skip_ratio > 0.0:
                # stochastic particle dropout per round (RandomSkipRatio)
                keep = rng.rand(B) >= min(random_skip_ratio, 0.95)
                w_round = w_round * keep[:, None]
            r_t = torch.as_tensor(rows, device=dev)
            out = rec.reconstruct(
                stack_t[r_t], poses_soft, ctf_t[r_t], pixel_size,
                subset=subset[rows].astype(np.int32),
                weights=w_round.reshape(-1).astype(np.float32),
                symmetry=symmetry, device=dev, **kw)
            del r_t, bank
            vol = _masked_lowpass(out.volume, mask, pixel_size, res)
            hard = np.argmax(s_top, axis=1)
            poses_hard = poses_soft.reshape(B, T, 5)[np.arange(B), hard]
            if track:
                cur_shifts = poses_hard[:, 3:5].astype(np.float32)
            logger.info(
                "round %d: posterior entropy %.2f bits (of %.2f), "
                "mean best score %.3f", r + 1,
                float(np.mean(-np.sum(w * np.log2(w + 1e-12), axis=1))),
                float(np.log2(T)), float(s_top.max(axis=1).mean()))
        beta *= beta_growth

    # hard phase: exhaustive FRM rounds on a finer lattice from the soft
    # phase's basin
    hard_end = float(hard_end_res if hard_end_res is not None
                     else max(end_res * 0.75, 2.5 * pixel_size))
    hard_ladder = np.geomspace(res_ladder[-1], hard_end, max(hard_rounds, 1))
    for r in range(hard_rounds):
        res = float(hard_ladder[r])
        cfg = frm.get_config(
            n, pixel_size, low_res=min(60.0, n * pixel_size),
            high_res=max(res, 2.5 * pixel_size),
            angular_step=max(angular_step * 0.6, 7.5), symmetry=symmetry,
            shift_extent=max(2.0, n * 0.05), shift_step=1.0, device=dev,
            **kw)
        with Timer(f"ab-initio(frm) hard round {r + 1}/{hard_rounds} "
                   f"@ {res:.0f} Å"):
            bank = cfg.bank(volume_to_fourier(as_f32(vol, dev)))
            # the fine shift search holds (rings x psi x shifts) phases
            # per row
            step = rows_per_call(dev, B, 16 * len(cfg.radii) * cfg.n_psi
                                 * len(cfg.shift_grid) + 64 * cfg.n ** 2)
            parts = [frm.frm_refine(stack_t[lo:lo + step], ctf_t[lo:lo + step],
                                    None, cfg, bank=bank)[0]
                     for lo in range(0, B, step)]
            poses_hard = _np(torch.cat(parts))
            del bank
            out = rec.reconstruct(
                stack_t, poses_hard, ctf_t, pixel_size,
                subset=subset.astype(np.int32), symmetry=symmetry,
                device=dev, **kw)
            vol = _masked_lowpass(out.volume, mask, pixel_size, res)
    # continuous polish tail: gradient rounds from the hard poses push
    # through the FRM lattice's quantization floor
    poses_hard = np.array(poses_hard, dtype=np.float32, copy=True)
    for r in range(polish_rounds):
        res = float(hard_ladder[-1]) * (0.85 ** r)
        Fv = volume_to_fourier(as_f32(vol, dev))
        pts = as_f32(refine3d.make_mask_points(
            n, pixel_size, min(60.0, n * pixel_size),
            max(res, 2.5 * pixel_size)), dev)
        step = rows_per_call(dev, B, 64 * n * n + 1024 * len(pts))
        parts = []
        for lo in range(0, B, step):
            p2, _sc = refine3d.local_refine(
                stack_t[lo:lo + step], ctf_t[lo:lo + step], Fv,
                as_f32(poses_hard[lo:lo + step], dev), pts, n, pixel_size,
                iters=24, **kw)
            parts.append(p2)
        poses_hard = _np(torch.cat(parts)).astype(np.float32)
        o = rec.reconstruct(stack_t, poses_hard, ctf_t, pixel_size,
                            symmetry=symmetry, device=dev, **kw)
        vol = _masked_lowpass(o.volume, mask, pixel_size,
                              max(res, 2.5 * pixel_size))
    return vol, poses_hard


def mean_particle_score(stack, ctf_params, poses, volume, pixel_size,
                        res: float, voltage_kv=300.0, cs_mm=2.7, w=0.07,
                        device="cuda"):
    """Mean CTF-weighted NCC of the stack against a model at given poses:
    the model-selection criterion of multi-seed ab initio."""
    dev = resolve_device(device)
    stack_t = as_f32(stack, dev)
    n = stack_t.shape[-1]
    pts = as_f32(refine3d.make_mask_points(n, pixel_size, 300.0, res), dev)
    F = volume_to_fourier(as_f32(volume, dev))
    ctf_t = as_f32(ctf_params, dev)
    poses_t = as_f32(poses, dev)
    B = stack_t.shape[0]
    step = rows_per_call(dev, B, 64 * n * n + 1024 * len(pts))
    total = 0.0
    for lo in range(0, B, step):
        _, scores = refine3d.local_refine(
            stack_t[lo:lo + step], ctf_t[lo:lo + step], F,
            poses_t[lo:lo + step], pts, n, pixel_size, iters=0,
            voltage_kv=voltage_kv, cs_mm=cs_mm, amplitude_contrast=w)
        total += float(scores.double().sum())
    return total / B


def ab_initio_multiseed(
    stack, ctf_params, pixel_size: float, n_seeds: int = 4, **kw,
):
    """Run `n_seeds` independent classic ab initio trajectories (seeds
    seed + 101 s) and keep the model whose particles score highest.
    Returns (volume, poses, best seed index, per-seed scores)."""
    end_res = float(kw.get("end_res", 12.0))
    base_seed = int(kw.pop("seed", 0))
    device = kw.get("device", "cuda")
    results = []
    scores = []
    for s in range(n_seeds):
        vol, poses = ab_initio(stack, ctf_params, pixel_size,
                               seed=base_seed + s * 101, **kw)
        sc = mean_particle_score(stack, ctf_params, poses, vol, pixel_size,
                                 end_res, device=device)
        results.append((vol, poses))
        scores.append(sc)
        logger.info("ab-initio seed %d: mean score %.4f", s, sc)
    best = int(np.argmax(scores))
    vol, poses = results[best]
    return vol, poses, best, scores
