"""Web platform RPC client.

Equivalent of the reference's streampyp/web.py `Web` class (:15-366): a
JSON-RPC client used to push per-iteration results to the nextPYP-style
web platform. Activated when PYP_TPU_WEBHOST is set (the reference keys on
NEXTPYP_WEBHOST, web.py:19); the refine loop calls it only then.

Transport uses urllib from the standard library (no requests dependency);
payloads with numpy arrays are JSON-encoded via lists.

The port's own copy of the part of pyp_tpu/stream/web.py it calls
(`write_reconstruction`); the request it sends is the same.
"""

from __future__ import annotations

import json
import os
import urllib.request

import numpy as np

from pyp_tpu_torch.utils import get_logger

logger = get_logger("web")


def _jsonable(obj):
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
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
        self._n_sent = 0

    @property
    def exists(self) -> bool:
        return bool(self.host)

    def _request(self, method: str, params: dict):
        self._n_sent += 1
        payload = json.dumps({"jsonrpc": "2.0", "id": self._n_sent,
                              "method": method,
                              "params": _jsonable(params)}).encode()
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

    # reference web.py:257-342
    def write_micrograph(self, name, summary: dict):
        return self._request("write_micrograph", {"name": name, **summary})

    def write_reconstruction(self, dataset, iteration, resolution, fsc=None):
        return self._request("write_reconstruction", {
            "dataset": dataset, "iteration": iteration,
            "resolution": resolution, "fsc": fsc,
        })
