"""Saved micrograph selections — the port's own copy of `load_selection`
(pyp_tpu/analysis/filters.py), which `-filter_sel` resolves through."""

from __future__ import annotations

import json
from pathlib import Path


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
