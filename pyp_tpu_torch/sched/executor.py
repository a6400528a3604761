"""The in-process executor of job graphs — the port's own copy of
`LocalExecutor` (pyp_tpu/sched/executor.py): everything runs in one
process, optionally on a thread pool (micrographs then share the one
card). Failed swarm items are retried up to their budget before the merge
runs. SLURM submission is not ported.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import random
import time
import traceback

from pyp_tpu_torch.sched.graph import Job, JobGraph
from pyp_tpu_torch.utils.log import get_logger

logger = get_logger("sched")


class LocalExecutor:
    """In-process executor. Fault injection: set fault_rate (or the
    PYP_TPU_FAULT_RATE env var) to make each leaf job fail with that
    probability on its first attempts — exercises the retry/merge-missing
    machinery."""

    def __init__(self, max_workers: int = 1, fault_rate: float | None = None,
                 fault_seed: int = 0):
        self.max_workers = max_workers
        if fault_rate is None:
            fault_rate = float(os.environ.get("PYP_TPU_FAULT_RATE", "0") or 0)
        self.fault_rate = fault_rate
        self._fault_rng = random.Random(fault_seed)

    def _run_job(self, graph: JobGraph, job: Job):
        job.status = "running"
        t0 = time.time()
        if (self.fault_rate > 0 and not job.deps
                and self._fault_rng.random() < self.fault_rate):
            job.status = "failed"
            job.error = "injected fault (PYP_TPU_FAULT_RATE)"
            job.elapsed = time.time() - t0
            logger.warning("job %s failed: injected fault", job.name)
            return
        try:
            if job.deps:  # merge-style: pass dep results
                results = {
                    d: graph.jobs[d].result
                    for d in job.deps
                    if graph.jobs[d].status == "done"
                }
                missing = [d for d in job.deps if graph.jobs[d].status != "done"]
                job.result = job.fn(results, missing, *job.args, **job.kwargs)
            else:
                job.result = job.fn(*job.args, **job.kwargs)
            job.status = "done"
        except Exception as e:  # noqa: BLE001
            job.status = "failed"
            job.error = f"{e}\n{traceback.format_exc()}"
            logger.warning("job %s failed: %s", job.name, e)
        job.elapsed = time.time() - t0

    def run(self, graph: JobGraph):
        """Run to completion with dependency ordering and retry-on-failure."""
        while not graph.is_complete():
            ready = graph.ready_jobs()
            if not ready:
                # retry failed leaf jobs with budget before declaring stall
                progressed = False
                for job in graph.jobs.values():
                    if job.status == "failed" and not job.deps:
                        if graph.resubmit(job):
                            progressed = True
                if not progressed:
                    break
                continue
            # merges run after trying to resubmit their failed deps
            for job in list(ready):
                if job.deps:
                    failed = [
                        graph.jobs[d] for d in job.deps
                        if graph.jobs[d].status == "failed"
                    ]
                    resub = [d for d in failed if graph.resubmit(d)]
                    if resub:
                        ready.remove(job)
            if self.max_workers > 1:
                leaf = [j for j in ready if not j.deps]
                with cf.ThreadPoolExecutor(self.max_workers) as pool:
                    list(pool.map(lambda j: self._run_job(graph, j), leaf))
                for job in [j for j in ready if j.deps]:
                    self._run_job(graph, job)
            else:
                for job in ready:
                    self._run_job(graph, job)
        return graph
