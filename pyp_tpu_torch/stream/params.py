"""Params-file protocol between the web platform and streaming daemons.

Rebuild of the reference's streampyp/params.py (`ParamsConfig` :138,
`parse_params_from_file` :213, `get_params_file_path` :186): the website
drops a parameter file next to the session's work dir; daemons re-read it
between polls so operators can retune a live session (picking radius, class
count, ...) without restarting. The reference file is TOML written by the
web server; here the canonical on-disk format is JSON (python can read TOML
via tomllib but cannot write it without extra deps), with read-side TOML
support for interop.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

from pyp_tpu_torch.utils import get_logger

logger = get_logger("stream")

PARAMS_FILENAME = ".pyp_tpu_session_params.json"


def params_file_path(work_dir=".") -> Path:
    """Where the web platform (or operator) drops live-session parameters.
    Overridable via PYP_TPU_PARAMS_FILE (the reference keys the path off
    its web config the same way)."""
    override = os.environ.get("PYP_TPU_PARAMS_FILE", "")
    if override:
        return Path(override)
    return Path(work_dir) / PARAMS_FILENAME


def write_params_file(params: dict, work_dir=".") -> Path:
    """Write (atomically: temp + rename) the live-session parameter file."""
    path = params_file_path(work_dir)
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_text(json.dumps(params, indent=1, default=str))
    tmp.replace(path)
    return path


def parse_params_file(path) -> dict:
    """Read a session params file (JSON, or TOML for interop with files
    written by the reference's web server) and coerce values through the
    schema so types match argparse-parsed parameters."""
    from pyp_tpu_torch.config import schema

    path = Path(path)
    text = path.read_text()
    try:
        raw = json.loads(text)
    except json.JSONDecodeError:
        import tomllib

        raw = tomllib.loads(text)
    out = {}
    by_name = {p.name: p for group in schema.SCHEMA.values() for p in group}
    for k, v in raw.items():
        spec = by_name.get(k)
        if spec is None:
            out[k] = v  # pass through unknown keys (forward compat)
            continue
        try:
            out[k] = spec.type(v) if not isinstance(v, spec.type) else v
        except (TypeError, ValueError):
            logger.warning("params file: cannot coerce %s=%r to %s; ignored",
                           k, v, spec.type.__name__)
    return out


class ParamsWatcher:
    """Poll-friendly reloader: `refresh()` returns the new parameter dict
    when the file appeared or changed since the last call, else None."""

    def __init__(self, work_dir="."):
        self.path = params_file_path(work_dir)
        self._mtime: float | None = None

    def refresh(self) -> dict | None:
        try:
            mtime = self.path.stat().st_mtime
        except FileNotFoundError:
            return None
        if self._mtime is not None and mtime <= self._mtime:
            return None
        self._mtime = mtime
        try:
            params = parse_params_file(self.path)
        except Exception as e:  # noqa: BLE001 - half-written file mid-poll
            logger.warning("params file %s unreadable (%s); will retry",
                           self.path, e)
            return None
        logger.info("params file reloaded: %d keys", len(params))
        return params
