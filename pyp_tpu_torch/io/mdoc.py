"""SerialEM .mdoc metadata parser.

Equivalent of the reference's mdoc handling (preprocess/core.py:836
`frames_from_mdoc`): tilt-series acquisition metadata — per-Z-value tilt
angle, exposure dose, defocus target, subframe path.
"""

from __future__ import annotations

import re
from pathlib import Path


def read(path) -> dict:
    """Parse an .mdoc into {"global": {...}, "sections": [{...}, ...]}."""
    out = {"global": {}, "sections": []}
    current = out["global"]
    for raw in Path(path).read_text().splitlines():
        line = raw.strip()
        if not line:
            continue
        m = re.match(r"\[ZValue\s*=\s*(\d+)\]", line)
        if m:
            current = {"ZValue": int(m.group(1))}
            out["sections"].append(current)
            continue
        if line.startswith("["):
            m = re.match(r"\[(\w+)\s*=\s*(.+)\]", line)
            if m:
                current = {m.group(1): m.group(2)}
            continue
        if "=" in line:
            key, val = line.split("=", 1)
            key = key.strip()
            val = val.strip()
            parts = val.split()
            try:
                nums = [float(p) for p in parts]
                current[key] = nums[0] if len(nums) == 1 else nums
            except ValueError:
                current[key] = val
    return out


def tilt_angles(mdoc: dict):
    return [s.get("TiltAngle", 0.0) for s in mdoc["sections"]]


def exposure_doses(mdoc: dict):
    return [s.get("ExposureDose", 0.0) for s in mdoc["sections"]]


def subframe_paths(mdoc: dict):
    out = []
    for s in mdoc["sections"]:
        p = s.get("SubFramePath", "")
        if isinstance(p, str):
            p = p.replace("\\", "/").split("/")[-1]
        out.append(p)
    return out
