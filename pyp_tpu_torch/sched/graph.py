"""Split -> swarm -> merge job graphs.

The reference fans each dataset out as one SLURM array element per
micrograph/tilt-series followed by a dependent merge job, with
retry-on-missing in the merge (bin/run/pyp:735-800, system/slurm.py:77-445,
streampyp/jobs.py:137-345; SURVEY §2.3/§5.3). This module models that shape
as an explicit graph the executors run:

  Job: name, fn (python callable) OR argv, dependencies, per-item payload.
  JobGraph.swarm(items, work_fn, merge_fn): the canonical pattern — one job
  per item, one merge depending on all of them; the merge receives the list
  of per-item results, sees which are missing, and can request resubmission
  (bounded by retries).

The port's own copy of pyp_tpu/sched/graph.py.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass
class Job:
    name: str
    fn: Callable[..., Any] | None = None
    args: tuple = ()
    kwargs: dict = dataclasses.field(default_factory=dict)
    deps: list = dataclasses.field(default_factory=list)   # job names
    item: Any = None            # payload for swarm elements
    retries: int = 0            # attempts used
    max_retries: int = 2
    # filled by executors:
    status: str = "pending"     # pending | running | done | failed | missing
    result: Any = None
    error: str | None = None
    elapsed: float = 0.0


class JobGraph:
    def __init__(self, name: str = "graph"):
        self.name = name
        self.jobs: dict[str, Job] = {}

    def add(self, job: Job) -> Job:
        if job.name in self.jobs:
            raise ValueError(f"duplicate job {job.name}")
        self.jobs[job.name] = job
        return job

    def swarm(self, stage: str, items, work_fn, merge_fn=None,
              max_retries: int = 2, merge_retries: int = 2):
        """Add per-item jobs + optional merge job. work_fn(item) -> result;
        merge_fn(results: dict[item_name, result]) -> merge result."""
        names = []
        for i, item in enumerate(items):
            item_name = getattr(item, "name", None) or (
                item.get("name") if isinstance(item, dict) else f"{i:05d}"
            )
            jname = f"{stage}.{item_name}"
            self.add(Job(name=jname, fn=work_fn, args=(item,), item=item,
                         max_retries=max_retries))
            names.append(jname)
        if merge_fn is not None:
            self.add(Job(name=f"{stage}.merge", fn=merge_fn,
                         deps=list(names), max_retries=merge_retries))
        return names

    def ready_jobs(self):
        """Jobs whose dependencies are all done (missing deps allowed for
        merges — the merge decides what to do about them)."""
        out = []
        for job in self.jobs.values():
            if job.status != "pending":
                continue
            deps = [self.jobs[d] for d in job.deps]
            if all(d.status in ("done", "failed") for d in deps):
                out.append(job)
        return out

    def is_complete(self):
        return all(j.status in ("done", "failed") for j in self.jobs.values())

    def failed_items(self, stage: str):
        return [
            j for j in self.jobs.values()
            if j.name.startswith(stage + ".") and not j.name.endswith(".merge")
            and j.status == "failed"
        ]

    def resubmit(self, job: Job) -> bool:
        """Re-queue a failed job if it has retry budget (the reference's
        merge-side missing-item resubmission, frealign.py:4924)."""
        if job.retries >= job.max_retries:
            return False
        job.retries += 1
        job.status = "pending"
        job.error = None
        return True
