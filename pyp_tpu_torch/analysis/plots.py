"""Diagnostic plots of the SPA loop — the port of `plot_fsc`,
`plot_guinier` and `plot_iteration_changes` of pyp_tpu/analysis/plots.py.
matplotlib is optional: each function imports it when called and raises
ImportError where it is missing, which callers turn into a warning and a
skipped plot."""

from __future__ import annotations

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_fsc(freqs, curves, pixel_size, out_path, labels=None,
             thresholds=(0.5, 0.143)):
    """FSC curves against spatial frequency (1/Å) with threshold lines."""
    plt = _pyplot()
    freqs = np.asarray(freqs) / pixel_size
    fig, ax = plt.subplots(figsize=(6, 4))
    if np.ndim(curves[0]) == 0:
        curves = [curves]
    for i, c in enumerate(curves):
        label = labels[i] if labels else f"curve {i}"
        ax.plot(freqs, np.asarray(c), lw=1.2, label=label)
    for t in thresholds:
        ax.axhline(t, color="gray", lw=0.6, ls="--")
    ax.set_xlabel("spatial frequency (1/Å)")
    ax.set_ylabel("FSC")
    ax.set_ylim(-0.1, 1.05)
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def plot_guinier(freqs2, ln_amp, fit_slope, fit_intercept, out_path):
    """Guinier plot: ln|F| against 1/d² with the fitted B-factor line."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(5, 3.2))
    ax.plot(np.asarray(freqs2), np.asarray(ln_amp), ".", ms=3,
            label="spherically averaged ln|F|")
    ax.plot(np.asarray(freqs2),
            fit_intercept + fit_slope * np.asarray(freqs2), "r-",
            label=f"B = {-4 * fit_slope:.0f} Å²")
    ax.set_xlabel("1/d² (1/Å²)")
    ax.set_ylabel("ln |F|")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def plot_iteration_changes(d_angles, d_shifts, scores, out_path, iteration):
    """Angular-change, shift-change and score histograms of one iteration."""
    plt = _pyplot()
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

