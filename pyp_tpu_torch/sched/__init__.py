"""Orchestration: split/swarm/merge job graphs, the local executor and
the workflow runner (`sched.workflow`)."""

from pyp_tpu_torch.sched.executor import LocalExecutor  # noqa: F401
from pyp_tpu_torch.sched.graph import Job, JobGraph  # noqa: F401
