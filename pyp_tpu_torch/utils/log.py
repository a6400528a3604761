"""Logging to stdout under the port's own logger root, with a TRACE level
and an optional file handler.

Equivalent of the reference's system/logging.py (custom TRACE level,
stdout and file handlers). The port's own copy of pyp_tpu/utils/log.py:
the same line format, the same `PYP_TPU_LOG_LEVEL` switch (info, debug or
trace) and the same `logger.trace` and `add_file_handler`, under the
root `pyp_tpu_torch`; `set_rank` tags the lines of a rank of a
distributed group.
"""

from __future__ import annotations

import logging
import os
import sys

TRACE = 5
logging.addLevelName(TRACE, "TRACE")

# the port logs under its own name, so a process that imports both packages
# does not print each line twice
_ROOT = "pyp_tpu_torch"
_FORMAT = "%(asctime)s %(levelname)7s %(name)s] %(message)s"
_configured = False
_handlers: list = []


def _configure():
    global _configured
    if _configured:
        return
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
    _handlers.append(handler)
    root = logging.getLogger(_ROOT)
    root.addHandler(handler)
    level = os.environ.get("PYP_TPU_LOG_LEVEL", "info").lower()
    root.setLevel({"debug": logging.DEBUG, "trace": TRACE}.get(
        level, logging.INFO))
    _configured = True


def get_logger(name: str = "") -> logging.Logger:
    _configure()
    logger = logging.getLogger(f"{_ROOT}.{name}" if name else _ROOT)

    def trace(msg, *args, **kw):
        logger.log(TRACE, msg, *args, **kw)

    logger.trace = trace  # type: ignore[attr-defined]
    return logger


def add_file_handler(path):
    """Also write the port's log lines to `path`; returns the handler."""
    _configure()
    handler = logging.FileHandler(path)
    handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
    _handlers.append(handler)
    logging.getLogger(_ROOT).addHandler(handler)
    return handler


def set_rank(rank: int, world: int):
    """Prefix every line of the port's handlers with `[rank r/world]` (a
    process of a distributed group)."""
    global _FORMAT
    _configure()
    _FORMAT = ("%(asctime)s %(levelname)7s " + f"[rank {rank}/{world}] "
               + "%(name)s] %(message)s")
    for handler in _handlers:
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
