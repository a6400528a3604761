"""Multi-class occupancy updates from per-class log-likelihoods.

Equivalent of the reference's analysis/occupancies.py (`occupancies` :34,
`occupancy_extended` :70, `classification_initialization` :324): after each
iteration of K-class refinement, per-particle class occupancies are the
softmax of per-class LogP (with an average-occupancy prior), and particles
feed each class reconstruction weighted by OCC/100.
"""

from __future__ import annotations

import numpy as np


def occupancies_from_logp(logp_per_class, prior_occ=None, temperature: float = 1.0):
    """(N, K) LogP -> (N, K) occupancies in percent (rows sum to 100).

    prior_occ: (K,) average class occupancies (mixing proportions) from the
    previous iteration; None = uniform.
    """
    logp = np.asarray(logp_per_class, dtype=np.float64) / max(temperature, 1e-6)
    K = logp.shape[1]
    if prior_occ is None:
        prior = np.zeros(K)
    else:
        p = np.maximum(np.asarray(prior_occ, dtype=np.float64), 1e-6)
        prior = np.log(p / p.sum())
    z = logp + prior[None, :]
    z -= z.max(axis=1, keepdims=True)
    w = np.exp(z)
    w /= w.sum(axis=1, keepdims=True)
    return w * 100.0


def tilt_angle_weights(tilt_angles):
    """Gaussian per-tilt weights favoring low-tilt projections.

    The reference weights each particle's per-projection LogP by a Gaussian
    in tilt angle with sigma = max|angle|/6 before computing tomo class
    occupancies (analysis/statistics.py:220 `weighted_by_tilt_angle`,
    occupancies.py:461): low-tilt images are thinner and better aligned, so
    they dominate the class evidence. All-zero angles -> uniform weights.
    """
    ang = np.asarray(tilt_angles, dtype=np.float64).ravel()
    if not np.count_nonzero(ang):
        return np.ones_like(ang)
    sigma = np.abs(ang).max() / 6.0
    return np.exp(-0.5 * (ang / sigma) ** 2)


def score_average_weights(scores, valid=None):
    """Per-tilt weights from dataset score averages.

    The reference's `refine_score_weighting` path (statistics.py:252
    `get_class_score_weight` + :272 `weighted_by_scoreavgs`,
    occupancies.py:154): each tilt's weight is the dataset-average of the
    per-particle max-over-class score at that tilt — tilts where alignment
    evidence is strong (early exposures, low tilt) count more, and the
    weighting adapts to the actual data instead of an angular model.

    scores: (T, P, K) per-tilt per-particle per-class scores;
    valid: (T, P) 0/1 in-bounds mask. Returns (T,) weights.
    """
    s = np.asarray(scores, dtype=np.float64)
    score_max = s.max(axis=2)  # (T, P) best-class score
    if valid is None:
        return score_max.mean(axis=1)
    v = np.asarray(valid, dtype=np.float64)
    return (score_max * v).sum(axis=1) / np.maximum(v.sum(axis=1), 1.0)


def aggregate_tilt_logp(scores, valid, tilt_angles, score_weighting=False):
    """(T, P, K) per-tilt scores -> (P, K) per-particle LogP via weighted
    average over tilts (the reference's tomo occupancy weighting,
    occupancies.py:154-168: score averages when `refine_score_weighting`,
    tilt-angle Gaussian otherwise)."""
    s = np.asarray(scores, dtype=np.float64)
    v = np.asarray(valid, dtype=np.float64)
    if score_weighting:
        w = score_average_weights(s, v)
    else:
        w = tilt_angle_weights(tilt_angles)
    wv = w[:, None] * v  # (T, P)
    num = np.einsum("tp,tpk->pk", wv, s)
    den = np.maximum(wv.sum(axis=0), 1e-9)
    return num / den[:, None]


def update_average_occupancies(occ):
    """(N, K) -> (K,) mixing proportions for the next iteration's prior."""
    return np.asarray(occ, dtype=np.float64).mean(axis=0)


def classification_initialization(n_particles: int, n_classes: int, seed: int = 0,
                                  jitter: float = 10.0):
    """Random soft start: occupancies near-uniform with jitter so classes
    diverge (reference classification_initialization :324)."""
    rng = np.random.RandomState(seed)
    occ = np.full((n_particles, n_classes), 100.0 / n_classes)
    occ += rng.uniform(-jitter, jitter, occ.shape)
    occ = np.clip(occ, 1e-3, None)
    occ *= 100.0 / occ.sum(axis=1, keepdims=True)
    return occ


def hard_assignments(occ):
    return np.argmax(np.asarray(occ), axis=1)
