"""Warp/M interop: .tomostar tilt-series descriptors.

The reference drives WarpTools as an external CLI (postprocess/warptools.py:
124 create_settings, :215 ts_import — WarpTools itself writes the .tomostar
files it later consumes). Here the hand-off is native: a .tomostar is a STAR
file with one row per tilt (columns wrpMovieName, wrpAngleTilt, wrpAxisAngle,
wrpDose, wrpAverageIntensity, wrpMaskedFraction), so we read/write it
directly from pipeline metadata and a user can continue a dataset in Warp/M
(or import one processed there) without running WarpTools.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from pyp_tpu_torch.io import star

COLUMNS = ("wrpMovieName", "wrpAngleTilt", "wrpAxisAngle", "wrpDose",
           "wrpAverageIntensity", "wrpMaskedFraction")


def write_tomostar(path, movie_names, tilt_angles, axis_angles, doses,
                   average_intensities=None, masked_fractions=None):
    """One .tomostar per tilt-series; rows ordered as given (Warp keeps the
    acquisition order and sorts by angle itself)."""
    T = len(movie_names)
    tilt_angles = np.asarray(tilt_angles, dtype=np.float64)
    axis_angles = np.broadcast_to(
        np.asarray(axis_angles, dtype=np.float64), (T,))
    doses = np.broadcast_to(np.asarray(doses, dtype=np.float64), (T,))
    if average_intensities is None:
        average_intensities = np.ones(T)
    if masked_fractions is None:
        masked_fractions = np.zeros(T)
    star.write({"root": {"loop": {
        "wrpMovieName": [str(m) for m in movie_names],
        "wrpAngleTilt": tilt_angles,
        "wrpAxisAngle": axis_angles,
        "wrpDose": doses,
        "wrpAverageIntensity": np.asarray(average_intensities, np.float64),
        "wrpMaskedFraction": np.asarray(masked_fractions, np.float64),
    }}}, path)


def read_tomostar(path) -> dict:
    """-> {"movie_names": [str], "tilt_angles", "axis_angles", "doses",
    "average_intensities", "masked_fractions"} (missing optional columns
    filled with defaults)."""
    blocks = star.read(path)
    block = next(iter(blocks.values()))
    loop = block.get("loop", {})
    if "wrpMovieName" not in loop or "wrpAngleTilt" not in loop:
        raise ValueError(f"{path}: not a .tomostar (missing wrp columns)")
    names = [str(m) for m in np.asarray(loop["wrpMovieName"])]
    T = len(names)

    def col(key, default):
        if key in loop:
            return np.asarray(loop[key], dtype=np.float64)
        return np.full(T, default, dtype=np.float64)

    return {
        "movie_names": names,
        "tilt_angles": np.asarray(loop["wrpAngleTilt"], dtype=np.float64),
        "axis_angles": col("wrpAxisAngle", 0.0),
        "doses": col("wrpDose", 0.0),
        "average_intensities": col("wrpAverageIntensity", 1.0),
        "masked_fractions": col("wrpMaskedFraction", 0.0),
    }


def tomostar_from_metadata(meta, movie_names=None) -> dict:
    """Build write_tomostar kwargs from an ItemMetadata tomo bundle
    ("tlt" angles, "xf" [shifts, axis], optional "dose")."""
    angles = np.asarray(meta["tlt"], dtype=np.float64)
    T = len(angles)
    xf = np.asarray(meta["xf"]) if "xf" in meta else np.zeros((T, 3))
    axis = xf[:, 2] if xf.shape[1] > 2 else np.zeros(T)
    doses = np.asarray(meta["dose"]) if "dose" in meta else np.zeros(T)
    if movie_names is None:
        movie_names = [f"{meta.name}_{t:03d}.mrc" for t in range(T)]
    return {
        "movie_names": movie_names, "tilt_angles": angles,
        "axis_angles": axis, "doses": doses,
    }


def export_tomostar_dir(items, out_dir):
    """items: {name: ItemMetadata}; writes <out_dir>/<name>.tomostar each."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for name, meta in items.items():
        p = out_dir / f"{name}.tomostar"
        write_tomostar(p, **tomostar_from_metadata(meta))
        paths.append(p)
    return paths
