"""Named stage timers and profiler spans.

Equivalent of the reference's utils/timer.py:27 Timer context that
annotates every pipeline stage ("refinement iteration 2 took ..."); the log
line is the same as in pyp_tpu/utils/timer.py. Here a stage waits for the
device work it launched before it reads the clock, and is a span.

`span` names a stretch of host code in a running torch profiler's trace
(`pyp::<name>`), on the profiler's clock with the CUDA activity it
launched, so a reader of the trace can put each kernel and each idle gap
on the device down to the code that launched it or left it waiting. The
spans are recorded only while a profiler (or `emit_nvtx`) is on.
"""

from __future__ import annotations

import contextlib
import time

import torch

from pyp_tpu_torch.utils.log import get_logger

logger = get_logger("timer")

PREFIX = "pyp::"


class span(contextlib.ContextDecorator):
    """A range named PREFIX + `name` in the trace of a running profiler, as
    a context manager or a decorator; with no profiler on, one flag check.
    `args`: a dict of scalars kept with the range (the mode number) where
    the profiler records shapes.

    The range is recorded as an operator (`_RecordFunctionFast`), not as a
    user annotation (`record_function`): the profiler mirrors each user
    annotation as a device event over the kernels launched inside it, which
    a reader that takes every device event for work counts as busy time."""

    def __init__(self, name: str, args: dict | None = None):
        if args is not None and not isinstance(args, dict):
            # the profiler's range entry aborts the process on a non-dict
            raise TypeError(f"span args must be a dict, not {type(args)}")
        self.name = name
        self.args = args
        self._range = None

    def _recreate_cm(self):
        return span(self.name, self.args)     # one range per decorated call

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            kw = {} if self.args is None else {"keyword_values": self.args}
            self._range = torch._C._profiler._RecordFunctionFast(
                PREFIX + self.name, **kw)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        rng, self._range = self._range, None
        if rng is not None:
            rng.__exit__(*exc)
        return False


class Timer:
    """Logs "<name> took <s>" for a stage, the device work it launched
    included (it synchronises the current CUDA device at exit where CUDA is
    initialised), and is the span `<name>`."""

    def __init__(self, name: str):
        self.name = name
        self.elapsed = 0.0

    def __enter__(self):
        self._span = span(self.name).__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.elapsed = time.perf_counter() - self.t0
        self._span.__exit__(*exc)
        logger.info("%s took %.2fs", self.name, self.elapsed)
        return False
