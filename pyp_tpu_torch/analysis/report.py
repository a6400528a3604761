"""Static HTML project report — the file-based counterpart of the
reference's web dashboards (nextPYP blocks show CTF/drift/FSC panels per
project; here one self-contained report.html with embedded images). The
port of pyp_tpu/analysis/report.py.

Collates, from a project directory:
* per-item metrics (analysis.filters.item_metrics): defocus/astigmatism/
  ctf fit/drift/particle counts (+ prism quality scores when present),
* refinement history from maps/ (*_fsc.txt curves, model-fit track),
* summary plots rendered with analysis.plots into base64 <img> tags.

matplotlib is optional: without it the report keeps its text, tables and
existing image artifacts and leaves the rendered figures out, with a
warning.
"""

from __future__ import annotations

import base64
import html
import io
import json
from pathlib import Path

import numpy as np

from pyp_tpu_torch.utils import get_logger

logger = get_logger("report")


def _img_tag(fig) -> str:
    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=110, bbox_inches="tight")
    import matplotlib.pyplot as plt

    plt.close(fig)
    data = base64.b64encode(buf.getvalue()).decode()
    return f'<img src="data:image/png;base64,{data}"/>'


def collect_project(work_dir=".", mode: str = "spr") -> dict:
    """Everything the report shows, as plain data."""
    from pyp_tpu_torch.analysis.filters import discover_bundles, item_metrics
    from pyp_tpu_torch.io.metadata import ItemMetadata

    items = {}
    for name in discover_bundles(work_dir):
        items[name] = item_metrics(
            ItemMetadata(name, work_dir, mode=mode).load())

    maps_dir = Path(work_dir) / "maps"
    fsc_files = sorted(maps_dir.glob("*_fsc.txt")) if maps_dir.exists() else []
    fscs = []
    for f in fsc_files:
        try:
            tab = np.loadtxt(f)
            fscs.append((f.stem, tab))
        except (ValueError, OSError):
            continue
    model_fit = []
    for f in (sorted(maps_dir.glob("*_model_fit.txt"))
              if maps_dir.exists() else []):
        for line in f.read_text().splitlines():
            toks = line.split()
            if len(toks) >= 2:
                model_fit.append((int(toks[0]), float(toks[1])))
    history = []
    for f in (sorted(maps_dir.glob("*_history.json"))
              if maps_dir.exists() else []):
        try:
            history.extend(json.loads(f.read_text()))
        except (ValueError, OSError):
            continue
    return {"items": items, "fscs": fscs, "model_fit": model_fit,
            "history": history}


def build_report(work_dir=".", dataset: str = "dataset",
                 mode: str = "spr", out_path=None) -> str:
    from pyp_tpu_torch.analysis.plots import _pyplot

    try:
        plt = _pyplot()
    except ImportError:
        logger.warning("matplotlib is not installed: the report leaves its "
                       "figures out")
        plt = None
    data = collect_project(work_dir, mode)
    items = data["items"]
    parts: list[str] = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        f"<title>{html.escape(dataset)} — pyp_tpu report</title>",
        "<style>body{font-family:sans-serif;margin:2em;max-width:70em}"
        "table{border-collapse:collapse}td,th{border:1px solid #ccc;"
        "padding:2px 8px;font-size:0.85em}img{max-width:100%}"
        "h2{border-bottom:1px solid #ddd}</style></head><body>",
        f"<h1>{html.escape(dataset)}</h1>",
        f"<p>{len(items)} items</p>",
    ]

    if items:
        # histograms of the headline per-item metrics
        keys = ["defocus", "ctf_res", "drift", "particles", "prism_score"]
        present = [k for k in keys
                   if any(k in m for m in items.values())]
        if present and plt is not None:
            fig, axes = plt.subplots(1, len(present),
                                     figsize=(3.2 * len(present), 2.6))
            axes = np.atleast_1d(axes)
            for ax, k in zip(axes, present):
                vals = [m[k] for m in items.values() if k in m]
                ax.hist(vals, bins=min(30, max(5, len(vals) // 2)))
                ax.set_title(k, fontsize=9)
            parts.append("<h2>Per-item metrics</h2>")
            parts.append(_img_tag(fig))

        # acquisition-order traces of the headline metrics (the
        # reference's plot_dataset time series, analysis/plot/core.py:251)
        if len(items) >= 3 and plt is not None:
            import tempfile

            from pyp_tpu_torch.analysis.plots import plot_dataset_timeseries

            with tempfile.NamedTemporaryFile(suffix=".png") as tf:
                plot_dataset_timeseries(items, tf.name)
                png = Path(tf.name).read_bytes()
            if png:
                parts.append("<h2>Dataset time series</h2>")
                parts.append('<img src="data:image/png;base64,'
                             f'{base64.b64encode(png).decode()}"/>')

        parts.append("<h2>Items</h2><table><tr><th>name</th>")
        cols = sorted({k for m in items.values() for k in m})
        parts.append("".join(f"<th>{html.escape(c)}</th>" for c in cols))
        parts.append("</tr>")
        for name in sorted(items):
            m = items[name]
            parts.append(f"<tr><td>{html.escape(name)}</td>")
            for c in cols:
                v = m.get(c, "")
                parts.append(
                    f"<td>{v:.3g}</td>" if isinstance(v, float)
                    else f"<td>{v}</td>")
            parts.append("</tr>")
        parts.append("</table>")

    if data["fscs"] and plt is not None:
        # refine_loop's *_fsc.txt store cycles/PIXEL; convert to 1/Å when a
        # half map is around to read the pixel size from
        pixel = None
        half = sorted((Path(work_dir) / "maps").glob("*_half1.mrc"))
        if half:
            try:
                from pyp_tpu_torch.io import mrc

                pixel = float(mrc.read_header(half[-1]).pixel_size)
            except (OSError, ValueError):
                pixel = None
        fig, ax = plt.subplots(figsize=(5.5, 3.2))
        for name, tab in data["fscs"][-6:]:
            x = tab[:, 0] / pixel if pixel else tab[:, 0]
            ax.plot(x, tab[:, 1], label=name.replace("_fsc", ""))
        ax.axhline(0.143, color="k", lw=0.5, ls="--")
        ax.set_xlabel("spatial frequency (1/Å)" if pixel
                      else "spatial frequency (cycles/pixel)")
        ax.set_ylabel("FSC")
        ax.legend(fontsize=7)
        parts.append("<h2>Refinement FSC</h2>")
        parts.append(_img_tag(fig))

    # existing image artifacts (class montages, CTF/drift plots, webp/png)
    arts = []
    for pat in ("*.png", "maps/*.png", "*.webp"):
        arts += sorted(Path(work_dir).glob(pat))
    arts = [a for a in arts if a.stat().st_size < 3_000_000][:12]
    if arts:
        parts.append("<h2>Artifacts</h2>")
        for a in arts:
            mime = "image/webp" if a.suffix == ".webp" else "image/png"
            data64 = base64.b64encode(a.read_bytes()).decode()
            parts.append(f"<p>{html.escape(a.name)}</p>"
                         f'<img src="data:{mime};base64,{data64}"/>')

    hist = data.get("history") or []
    if hist:
        # refinement history: resolution, pose-change, occupancy traces
        res_rows = [(h["iteration"], h["resolution"]) for h in hist
                    if "resolution" in h]
        chg_rows = [(h["iteration"], h["median_angular_change_deg"])
                    for h in hist if "median_angular_change_deg" in h]
        occ_rows = [h for h in hist
                    if h.get("occupancies", h.get("occupancy"))]
        n_panels = bool(res_rows) + bool(chg_rows) + bool(occ_rows)
        if n_panels and plt is not None:
            fig, axes = plt.subplots(1, n_panels,
                                     figsize=(4.0 * n_panels, 2.8),
                                     squeeze=False)
            col = 0
            if res_rows:
                ax = axes[0][col]; col += 1
                ax.plot(*zip(*res_rows), "o-")
                ax.set_xlabel("iteration")
                ax.set_ylabel("FSC(0.143) resolution (Å)")
                ax.invert_yaxis()
            if chg_rows:
                ax = axes[0][col]; col += 1
                ax.plot(*zip(*chg_rows), "o-", color="tab:orange")
                ax.set_xlabel("iteration")
                ax.set_ylabel("median angular change (°)")
            if occ_rows:
                ax = axes[0][col]
                its = [h["iteration"] for h in occ_rows]
                occ = np.asarray([
                    h.get("occupancies", h.get("occupancy"))
                    for h in occ_rows])
                for k in range(occ.shape[1]):
                    ax.plot(its, occ[:, k], "o-", ms=3,
                            label=f"class {k + 1}")
                ax.set_xlabel("iteration")
                ax.set_ylabel("mean occupancy (%)")
                ax.legend(fontsize=6)
            fig.tight_layout()
            parts.append("<h2>Refinement history</h2>")
            parts.append(_img_tag(fig))

    if data["model_fit"] and plt is not None:
        fig, ax = plt.subplots(figsize=(4.0, 2.6))
        its, ccs = zip(*data["model_fit"])
        ax.plot(its, ccs, "o-")
        ax.set_xlabel("iteration")
        ax.set_ylabel("model-map CC")
        parts.append("<h2>Model fit</h2>")
        parts.append(_img_tag(fig))

    parts.append("</body></html>")
    out = Path(out_path or Path(work_dir) / f"{dataset}_report.html")
    out.write_text("".join(parts))
    return str(out)
