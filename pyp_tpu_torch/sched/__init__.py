"""Orchestration: split/swarm/merge job graphs and the local executor."""

from pyp_tpu_torch.sched.executor import LocalExecutor  # noqa: F401
from pyp_tpu_torch.sched.graph import Job, JobGraph  # noqa: F401
