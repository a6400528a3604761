"""Named stage timers.

Equivalent of the reference's utils/timer.py:27 Timer context that
annotates every pipeline stage ("refinement iteration 2 took ...").

The port's own copy of the context manager in pyp_tpu/utils/timer.py; the
log line is the same in both.
"""

from __future__ import annotations

import time

from pyp_tpu_torch.utils.log import get_logger

logger = get_logger("timer")


class Timer:
    def __init__(self, name: str):
        self.name = name
        self.elapsed = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        logger.info("%s took %.2fs", self.name, self.elapsed)
        return False
