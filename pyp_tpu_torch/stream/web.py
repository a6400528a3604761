"""Web platform RPC client.

Equivalent of the reference's streampyp/web.py `Web` class (:15-366): a
JSON-RPC client used to push lifecycle signals and per-item results to the
nextPYP-style web platform. Activated when PYP_TPU_WEBHOST is set (the
reference keys on NEXTPYP_WEBHOST, web.py:19); otherwise every call is a
structured no-op logged at TRACE, so pipeline code can call unconditionally.

Transport uses urllib from the standard library (no requests dependency);
payloads with numpy arrays are JSON-encoded via lists.
"""

from __future__ import annotations

import json
import os
import urllib.request
from pathlib import Path

import numpy as np

from pyp_tpu_torch.utils import get_logger

logger = get_logger("web")


def _jsonable(obj):
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if isinstance(obj, Path):
        return str(obj)
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    return obj


class Web:
    """JSON-RPC client; `Web.exists` mirrors the reference's activation."""

    def __init__(self, host: str | None = None, token: str | None = None):
        self.host = host or os.environ.get("PYP_TPU_WEBHOST", "")
        self.token = token or os.environ.get("PYP_TPU_WEBTOKEN", "")
        self.sent: list[dict] = []  # local journal (also used by tests)

    @property
    def exists(self) -> bool:
        return bool(self.host)

    def _request(self, method: str, params: dict):
        record = {"method": method, "params": _jsonable(params)}
        self.sent.append(record)
        if not self.exists:
            logger.debug("web (inactive): %s", method)
            return None
        payload = json.dumps(
            {"jsonrpc": "2.0", "id": len(self.sent), **record}
        ).encode()
        req = urllib.request.Request(
            self.host.rstrip("/") + "/rpc",
            data=payload,
            headers={
                "Content-Type": "application/json",
                **({"Authorization": f"Bearer {self.token}"} if self.token else {}),
            },
        )
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return json.loads(resp.read().decode())
        except OSError as e:
            logger.warning("web rpc %s failed: %s", method, e)
            return None

    # -- lifecycle (reference web.py:89-108) --------------------------------
    def slurm_started(self, job_id, array_id=None):
        return self._request("slurm_started", {"job_id": job_id, "array_id": array_id})

    def slurm_ended(self, job_id, array_id=None, exit_code=0):
        return self._request("slurm_ended", {"job_id": job_id, "array_id": array_id,
                                             "exit_code": exit_code})

    def failed(self, job_id, message):
        return self._request("failed", {"job_id": job_id, "message": message})

    def log(self, line, level="INFO"):
        return self._request("log", {"line": str(line), "level": level})

    # -- results (reference web.py:257-342) ---------------------------------
    def write_micrograph(self, name, summary: dict):
        return self._request("write_micrograph", {"name": name, **summary})

    def write_tiltseries(self, name, summary: dict):
        return self._request("write_tiltseries", {"name": name, **summary})

    def write_reconstruction(self, dataset, iteration, resolution, fsc=None):
        return self._request("write_reconstruction", {
            "dataset": dataset, "iteration": iteration,
            "resolution": resolution, "fsc": fsc,
        })

    def write_refinement(self, dataset, iteration, table_stats: dict):
        return self._request("write_refinement", {
            "dataset": dataset, "iteration": iteration, **table_stats,
        })

    def write_classes(self, dataset, montage_path, occupancy):
        return self._request("write_classes", {
            "dataset": dataset, "montage": str(montage_path),
            "occupancy": occupancy,
        })
