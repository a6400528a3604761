"""Timers and logging (the port's copies of pyp_tpu.utils' log and timer)."""

from pyp_tpu_torch.utils.log import get_logger  # noqa: F401
from pyp_tpu_torch.utils.timer import Timer  # noqa: F401
