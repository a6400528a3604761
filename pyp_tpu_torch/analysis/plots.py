"""Diagnostic plots — the port of pyp_tpu/analysis/plots.py: CTF fits,
drift, FSC and Guinier curves, iteration changes, occupancy histories,
score histograms, tilt-series panels, local trajectories, angular and
defocus distributions, class montages, dataset time series and volume
montages.
matplotlib is optional: each function imports it when called and raises
ImportError where it is missing, which callers turn into a warning and a
skipped plot. `write_bild_angular_distribution` writes text and needs
no matplotlib."""

from __future__ import annotations

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_ctf_fit(g_axis, radial, norm_radial, model, fit, out_path):
    """CTFFIND-style fit panel: radial spectrum vs fitted CTF^2."""
    plt = _pyplot()
    fig, axes = plt.subplots(2, 1, figsize=(8, 6), sharex=True)
    axes[0].plot(g_axis, radial, lw=0.8)
    axes[0].set_ylabel("power")
    axes[0].set_yscale("log")
    axes[1].plot(g_axis, norm_radial, lw=0.8, label="data (normalized)")
    axes[1].plot(g_axis, model, lw=0.8, label="CTF$^2$ fit")
    axes[1].set_xlabel("spatial frequency (1/Å)")
    axes[1].legend(loc="upper right", fontsize=8)
    axes[1].set_title(
        f"df1={float(fit.df1):.0f} Å  df2={float(fit.df2):.0f} Å  "
        f"ast={float(fit.angast):.1f}°  fit_res={float(fit.fit_res):.2f} Å",
        fontsize=9,
    )
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def plot_drift(shifts, out_path):
    plt = _pyplot()
    shifts = np.asarray(shifts)
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.plot(shifts[:, 1], shifts[:, 0], "o-", ms=3)
    ax.plot(shifts[0, 1], shifts[0, 0], "rs", label="first frame")
    ax.set_xlabel("x shift (px)")
    ax.set_ylabel("y shift (px)")
    ax.set_title("beam-induced motion")
    ax.legend()
    ax.set_aspect("equal")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


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



def plot_occupancy_history(history, out_path):
    """Class occupancy vs iteration. history: list of dicts with
    'iteration' and 'occupancies' (or 'occupancy'), the per-class mean
    occupancy in %."""
    rows = [(h["iteration"], h.get("occupancies", h.get("occupancy")))
            for h in history
            if h.get("occupancies", h.get("occupancy")) is not None]
    if not rows:
        return
    plt = _pyplot()
    its = [r[0] for r in rows]
    occ = np.asarray([r[1] for r in rows])  # (n_iter, K)
    fig, ax = plt.subplots(figsize=(5.5, 3.2))
    for k in range(occ.shape[1]):
        ax.plot(its, occ[:, k], "o-", ms=3, label=f"class {k + 1}")
    ax.set_xlabel("iteration")
    ax.set_ylabel("mean occupancy (%)")
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def histogram_particle_scores(scores, threshold, out_path, title=""):
    """Score histogram with the cleaning threshold marked."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(5, 3.2))
    ax.hist(np.asarray(scores), bins=50)
    ax.axvline(float(threshold), color="r", ls="--",
               label=f"threshold {float(threshold):.3g}")
    ax.set_xlabel("score")
    ax.set_ylabel("particles")
    if title:
        ax.set_title(title, fontsize=9)
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def plot_tilt_series_panel(angles, xf, ctf, out_path):
    """Per-series alignment + CTF diagnostics: tilt-shift trajectory,
    per-tilt defocus/astigmatism, and per-tilt fit quality (the reference's
    plot_trajectory_raw + plot_tomo_ctf panels, analysis/plot/core.py:497,
    :1678 — one combined sheet per tilt-series here).

    angles: (T,) tilt angles in degrees; xf: (T, 3) [sy, sx, axis_angle]
    from tilt alignment; ctf: (T, 5) [df1, df2, angast, cc, fit_res]."""
    plt = _pyplot()
    angles = np.asarray(angles)
    xf = np.asarray(xf) if xf is not None else None
    ctf = np.asarray(ctf) if ctf is not None else None
    n_rows = 1 + (xf is not None) + (ctf is not None)
    fig, axes = plt.subplots(n_rows, 2, figsize=(9, 2.6 * n_rows),
                             squeeze=False)
    order = np.argsort(angles)
    ax = axes[0][0]
    ax.plot(np.arange(len(angles)), angles, "o-", ms=3)
    ax.set_xlabel("acquisition index")
    ax.set_ylabel("tilt angle (°)")
    ax.set_title("tilt scheme", fontsize=9)
    axes[0][1].axis("off")
    row = 1
    if xf is not None:
        ax = axes[row][0]
        ax.plot(xf[order, 1], xf[order, 0], "o-", ms=3)
        ax.set_xlabel("x shift (px)")
        ax.set_ylabel("y shift (px)")
        ax.set_title("tilt-shift trajectory (angle order)", fontsize=9)
        ax.set_aspect("equal")
        ax = axes[row][1]
        ax.plot(angles[order], np.hypot(xf[order, 0], xf[order, 1]), "o-",
                ms=3)
        ax.set_xlabel("tilt angle (°)")
        ax.set_ylabel("|shift| (px)")
        ax.set_title(f"axis angle {xf[0, 2]:.1f}°", fontsize=9)
        row += 1
    if ctf is not None:
        ax = axes[row][0]
        ax.plot(angles[order], ctf[order, 0] / 1e4, "o-", ms=3,
                label="df1")
        ax.plot(angles[order], ctf[order, 1] / 1e4, "o-", ms=3,
                label="df2")
        ax.set_xlabel("tilt angle (°)")
        ax.set_ylabel("defocus (µm)")
        ax.legend(fontsize=7)
        ax.set_title("per-tilt defocus", fontsize=9)
        ax = axes[row][1]
        ax.plot(angles[order], ctf[order, 4], "o-", ms=3, color="tab:red")
        ax.set_xlabel("tilt angle (°)")
        ax.set_ylabel("CTF fit resolution (Å)")
        ax.set_title("per-tilt fit quality", fontsize=9)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def plot_local_trajectories(coords, local_shifts, shape, out_path,
                            scale: float = 20.0):
    """Per-particle local motion trajectories over the micrograph footprint
    (the reference's plot_trajectories, analysis/plot/core.py:1722).

    coords: (P, 2) particle centers (y, x) px; local_shifts: (P, F, 2)
    per-frame shifts px; shape: (ny, nx)."""
    plt = _pyplot()
    coords = np.asarray(coords)
    traj = np.asarray(local_shifts)
    fig, ax = plt.subplots(figsize=(6, 6 * shape[0] / max(shape[1], 1)))
    for c, t in zip(coords, traj):
        path = c[None] + scale * (t - t.mean(axis=0, keepdims=True))
        ax.plot(path[:, 1], path[:, 0], "-", lw=0.8)
        ax.plot(path[0, 1], path[0, 0], "k.", ms=2)
    ax.set_xlim(0, shape[1])
    ax.set_ylim(shape[0], 0)
    ax.set_title(f"local trajectories (×{scale:g})", fontsize=9)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def plot_angular_distribution(phi, theta, out_path):
    """Mollweide-projected heat map of viewing directions."""
    plt = _pyplot()
    phi = np.radians(np.asarray(phi) % 360) - np.pi
    theta = np.radians(np.asarray(theta))
    lat = np.pi / 2 - theta
    fig = plt.figure(figsize=(7, 4))
    ax = fig.add_subplot(111, projection="mollweide")
    h = ax.hexbin(phi, lat, gridsize=30, mincnt=1, cmap="viridis")
    fig.colorbar(h, ax=ax, shrink=0.7, label="particles")
    ax.set_title("angular distribution")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def plot_defocus_histogram(df1, df2, out_path):
    """Histogram of the micrographs' mean defocus (µm)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.hist(0.5 * (np.asarray(df1) + np.asarray(df2)) / 1e4, bins=40)
    ax.set_xlabel("defocus (µm)")
    ax.set_ylabel("micrographs")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def class_montage(class_avgs, out_path, columns: int = 10, occupancy=None):
    """Contact sheet of 2D class averages (the reference's contact_sheet),
    each scaled between its 1st and 99th percentile, with the occupancy
    written on it; returns the sheet."""
    plt = _pyplot()
    avgs = np.asarray(class_avgs)
    K, n, _ = avgs.shape
    cols = min(columns, K)
    rows = (K + cols - 1) // cols
    sheet = np.zeros((rows * n, cols * n), dtype=np.float32)
    for k in range(K):
        r, c = divmod(k, cols)
        img = avgs[k]
        lo, hi = np.percentile(img, [1, 99])
        sheet[r * n:(r + 1) * n, c * n:(c + 1) * n] = np.clip(
            (img - lo) / max(hi - lo, 1e-6), 0, 1)
    fig, ax = plt.subplots(figsize=(cols, rows))
    ax.imshow(sheet, cmap="gray", interpolation="nearest")
    if occupancy is not None:
        for k in range(K):
            r, c = divmod(k, cols)
            ax.text(c * n + 2, r * n + 10, f"{int(occupancy[k])}",
                    color="yellow", fontsize=7)
    ax.axis("off")
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return sheet


def write_bild_angular_distribution(phi, theta, out_path, radius: float = 50.0):
    """ChimeraX .bild file of the viewing-direction density (the
    reference's par2bild): the views binned on a 500-point Fibonacci
    sphere, one coloured cylinder per occupied bin."""
    import torch

    from pyp_tpu_torch.core.geometry import euler_to_matrix

    phi = torch.as_tensor(np.asarray(phi, dtype=np.float32))
    theta = torch.as_tensor(np.asarray(theta, dtype=np.float32))
    R = euler_to_matrix(phi, theta, torch.zeros_like(phi)).numpy()
    views = R[:, 2, :]
    k = 500
    idx = np.arange(k) + 0.5
    ga = np.pi * (1 + 5**0.5) * idx
    z = 1 - 2 * idx / k
    r = np.sqrt(1 - z * z)
    seeds = np.stack([r * np.cos(ga), r * np.sin(ga), z], axis=1)
    counts = np.bincount(np.argmax(views @ seeds.T, axis=1), minlength=k)
    cmax = max(counts.max(), 1)
    with open(out_path, "w") as f:
        f.write(".comment pyp_tpu angular distribution\n")
        for s, cnt in zip(seeds, counts):
            if cnt == 0:
                continue
            h = cnt / cmax
            f.write(f".color {h:.2f} 0 {1 - h:.2f}\n")
            tip = s * radius * (1.0 + 0.3 * h)
            base = s * radius
            f.write(
                f".cylinder {base[0]:.2f} {base[1]:.2f} {base[2]:.2f} "
                f"{tip[0]:.2f} {tip[1]:.2f} {tip[2]:.2f} {0.5 + h:.2f}\n")


def plot_dataset_timeseries(items, out_path,
                            keys=("defocus", "ctf_res", "drift",
                                  "particles")):
    """Dataset-wide per-item metric traces in acquisition order (the
    reference's plot_dataset, the web Table-view time series).

    items: {name: {metric: value}} as report.collect_project gives them."""
    names = sorted(items)
    present = [k for k in keys if any(k in items[n] for n in names)]
    if not present:
        return
    plt = _pyplot()
    fig, axes = plt.subplots(len(present), 1,
                             figsize=(8, 1.9 * len(present)), sharex=True)
    axes = np.atleast_1d(axes)
    for ax, k in zip(axes, present):
        xs = [i for i, n in enumerate(names) if k in items[n]]
        ys = [items[n][k] for n in names if k in items[n]]
        ax.plot(xs, ys, ".-", ms=3, lw=0.7)
        ax.set_ylabel(k, fontsize=8)
    axes[-1].set_xlabel("item (acquisition order)")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def volume_montage(volume, out_path, axis: int = 0, n_slices: int = 9):
    """Slice montage of a 3D map (the reference's map montage)."""
    plt = _pyplot()
    vol = np.asarray(volume)
    n = vol.shape[axis]
    picks = np.linspace(n // 6, n - n // 6 - 1, n_slices).astype(int)
    cols = int(np.ceil(np.sqrt(n_slices)))
    rows = int(np.ceil(n_slices / cols))
    fig, axes = plt.subplots(rows, cols, figsize=(2.2 * cols, 2.2 * rows))
    axes = np.atleast_1d(axes).ravel()
    for ax in axes:
        ax.axis("off")
    for k, z in enumerate(picks):
        sl = np.take(vol, z, axis=axis)
        lo, hi = np.percentile(sl, [1, 99])
        axes[k].imshow(sl, cmap="gray", vmin=lo, vmax=hi)
        axes[k].set_title(f"{z}", fontsize=7)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
