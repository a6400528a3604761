"""Timers, profiler spans and logging (the port's copies of pyp_tpu.utils'
log and timer; `utils.notify` mirrors the log and sends completion mail)."""

from pyp_tpu_torch.utils.log import get_logger  # noqa: F401
from pyp_tpu_torch.utils.timer import Timer, span  # noqa: F401
