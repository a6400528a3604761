"""RELION STAR file reader/writer (data blocks with loop_ tables).

Functional equivalent of the reference's star import/export
(pyp/inout/metadata/pyp_metadata.py:763+,
cistem_star_file.py `to_star` :779). A STAR file parses into
{block_name: {"fields": {key: str}, "loop": {column: np.ndarray}}}.
"""

from __future__ import annotations

import numpy as np


def _coerce(values):
    try:
        arr = np.asarray(values, dtype=np.float64)
    except (ValueError, TypeError):
        return np.asarray(values, dtype=object)
    as_int = arr.astype(np.int64)
    if np.all(np.isfinite(arr)) and np.array_equal(as_int.astype(np.float64), arr):
        return as_int
    return arr


def read(path) -> dict:
    blocks = {}
    block = None
    loop_cols = None
    loop_rows = []
    in_loop_header = False

    def flush():
        if block is not None and loop_cols:
            cols = list(zip(*loop_rows)) if loop_rows else [[] for _ in loop_cols]
            block["loop"] = {c: _coerce(list(v)) for c, v in zip(loop_cols, cols)}

    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            if line.startswith("data_"):
                flush()
                block = {"fields": {}, "loop": {}}
                blocks[line[5:] or "root"] = block
                loop_cols, loop_rows, in_loop_header = None, [], False
                continue
            if block is None:
                block = {"fields": {}, "loop": {}}
                blocks["root"] = block
            if line == "loop_":
                flush()
                loop_cols, loop_rows, in_loop_header = [], [], True
                continue
            if line.startswith("_"):
                parts = line.split()
                key = parts[0].lstrip("_")
                if in_loop_header:
                    loop_cols.append(key)
                else:
                    block["fields"][key] = parts[1] if len(parts) > 1 else ""
                continue
            if loop_cols is not None:
                in_loop_header = False
                toks = line.split()
                if len(toks) == len(loop_cols):
                    loop_rows.append(toks)
    flush()
    return blocks


def write(blocks: dict, path):
    with open(path, "w") as f:
        f.write("# written by pyp_tpu\n\n")
        for name, block in blocks.items():
            f.write(f"data_{name if name != 'root' else ''}\n\n")
            for k, v in block.get("fields", {}).items():
                f.write(f"_{k}  {v}\n")
            loop = block.get("loop", {})
            if loop:
                f.write("\nloop_\n")
                cols = list(loop.keys())
                for i, c in enumerate(cols):
                    f.write(f"_{c} #{i + 1}\n")
                arrays = [np.asarray(loop[c]) for c in cols]
                n = len(arrays[0]) if arrays else 0
                for r in range(n):
                    toks = []
                    for a in arrays:
                        v = a[r]
                        if isinstance(v, (np.floating, float)):
                            toks.append(f"{v:.6f}")
                        else:
                            toks.append(str(v))
                    f.write("  ".join(toks) + "\n")
            f.write("\n")
