"""Logging to stdout under the port's own logger root.

Equivalent of the reference's system/logging.py stdout handler. The port's
own copy of the part of pyp_tpu/utils/log.py it uses: the same line
format and the same `PYP_TPU_LOG_LEVEL` switch (info or debug; the port
logs nothing below debug, so trace reads as debug).
"""

from __future__ import annotations

import logging
import os
import sys

# the port logs under its own name, so a process that imports both packages
# does not print each line twice
_ROOT = "pyp_tpu_torch"
_FORMAT = "%(asctime)s %(levelname)7s %(name)s] %(message)s"
_configured = False


def _configure():
    global _configured
    if _configured:
        return
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
    root = logging.getLogger(_ROOT)
    root.addHandler(handler)
    level = os.environ.get("PYP_TPU_LOG_LEVEL", "info").lower()
    root.setLevel(logging.DEBUG if level in ("debug", "trace")
                  else logging.INFO)
    _configured = True


def get_logger(name: str = "") -> logging.Logger:
    _configure()
    return logging.getLogger(f"{_ROOT}.{name}" if name else _ROOT)
