"""Micrograph / tilt-series filters: select per-item subsets by metadata
metrics for downstream processing.

The reference exposes this as the web UI's "Filters" feature (criteria
sliders over preprocessing metrics plus manual include/exclude,
docs/guide/filters.rst); batch runs then honor the saved selection. Here
the same contract is file-based: `pyp_tpu filter -filter_criteria ...`
evaluates criteria over every item's metadata bundle and writes a
`<dataset>_<name>.filter.json` selection that any downstream mode loads via
`-filter_sel`.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np

from pyp_tpu_torch.io.metadata import ItemMetadata

# metric name -> how to derive it from a metadata bundle
_OPS = {"<=": np.less_equal, ">=": np.greater_equal, "<": np.less,
        ">": np.greater, "==": np.equal, "!=": np.not_equal}


def item_metrics(meta: ItemMetadata) -> dict:
    """Standard per-item quality metrics from a metadata bundle.

    Mirrors the columns the reference's table view filters on: CTF fit
    (defocus, astigmatism, CC, fit resolution), accumulated drift,
    particle and tilt counts."""
    m: dict = {}
    if "ctf" in meta:
        ctf = np.atleast_2d(np.asarray(meta["ctf"], dtype=np.float64))
        df1, df2 = ctf[:, 0], ctf[:, 1]
        m["defocus"] = float(np.mean((df1 + df2) / 2))
        m["astigmatism"] = float(np.mean(np.abs(df1 - df2)))
        if ctf.shape[1] > 4:
            m["ctf_cc"] = float(np.mean(ctf[:, 4]))
        if ctf.shape[1] > 5:
            m["ctf_res"] = float(np.mean(ctf[:, 5]))
    if "drift" in meta:
        d = np.asarray(meta["drift"], dtype=np.float64)
        steps = np.diff(d.reshape(-1, d.shape[-2], d.shape[-1])
                        if d.ndim == 3 else d[None], axis=-2)
        m["drift"] = float(np.mean(np.sum(
            np.linalg.norm(steps, axis=-1), axis=-1)))
    if "box" in meta:
        m["particles"] = float(len(meta["box"]))
    if "tlt" in meta:
        m["tilts"] = float(len(meta["tlt"]))
    # scalar extras (e.g. image statistics) pass straight through
    for k, v in meta.scalars.items():
        if isinstance(v, (int, float)) and k not in m:
            m[k] = float(v)
    return m


def parse_criteria(spec: str) -> list[tuple[str, str, float]]:
    """Parse `"ctf_res<8, drift<=60 particles>10"` into clauses."""
    clauses = []
    for tok in re.split(r"[,\s]+", spec.strip()):
        if not tok:
            continue
        mt = re.match(r"^([A-Za-z_][\w]*)\s*(<=|>=|==|!=|<|>)\s*"
                      r"(-?\d+\.?\d*)$", tok)
        if not mt:
            raise ValueError(f"bad filter clause {tok!r} "
                             "(want metric<op>value, e.g. ctf_res<8)")
        clauses.append((mt.group(1), mt.group(2), float(mt.group(3))))
    return clauses


def evaluate(metrics: dict, clauses) -> bool:
    """An item passes iff every clause on a PRESENT metric holds; clauses
    naming metrics the item lacks fail it (unknown quality = excluded)."""
    for name, op, val in clauses:
        if name not in metrics:
            return False
        if not bool(_OPS[op](metrics[name], val)):
            return False
    return True


def discover_bundles(work_dir=".") -> list[str]:
    """Item names with metadata bundles under a project dir."""
    return sorted(p.name[: -len(".meta.npz")]
                  for p in Path(work_dir).glob("*.meta.npz"))


def apply_filter(work_dir, criteria: str, mode: str = "spr",
                 include=(), exclude=()) -> tuple[list, dict]:
    """Evaluate criteria over every bundle. Returns (kept names,
    {name: metrics})."""
    clauses = parse_criteria(criteria) if criteria else []
    include, exclude = set(include), set(exclude)
    kept, table = [], {}
    for name in discover_bundles(work_dir):
        meta = ItemMetadata(name, work_dir, mode=mode).load()
        metrics = item_metrics(meta)
        table[name] = metrics
        ok = evaluate(metrics, clauses) if clauses else True
        if name in include:
            ok = True
        if name in exclude:
            ok = False
        if ok:
            kept.append(name)
    return kept, table


def save_selection(path, kept, criteria: str, table=None):
    payload = {"criteria": criteria, "keep": list(kept)}
    if table is not None:
        payload["metrics"] = table
    Path(path).write_text(json.dumps(payload, indent=1))
    return str(path)


def load_selection(path_or_name, work_dir=".", dataset: str = "") -> set:
    """Resolve a `-filter_sel` value: a path to a .filter.json, or a bare
    filter name saved as `<dataset>_<name>.filter.json`."""
    p = Path(path_or_name)
    if not p.exists():
        cand = Path(work_dir) / f"{dataset}_{path_or_name}.filter.json"
        if not cand.exists():
            raise FileNotFoundError(
                f"filter selection {path_or_name!r} not found "
                f"(also tried {cand})")
        p = cand
    return set(json.loads(p.read_text())["keep"])
