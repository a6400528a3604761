"""Saved micrograph selections and the project's bundles — the port's own
copies of `load_selection`, which `-filter_sel` resolves through, and
`discover_bundles`, which `prism` reads (pyp_tpu/analysis/filters.py)."""

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


def discover_bundles(work_dir=".") -> list[str]:
    """Item names with metadata bundles under a project dir."""
    return sorted(p.name[: -len(".meta.npz")]
                  for p in Path(work_dir).glob("*.meta.npz"))
