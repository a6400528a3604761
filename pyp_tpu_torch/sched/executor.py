"""Executors of job graphs — the port's own copy of
pyp_tpu/sched/executor.py: the in-process `LocalExecutor` (everything runs
in one process, optionally on a thread pool, whose micrographs then share
the one card; failed swarm items are retried up to their budget before
the merge runs) and the SLURM emitter `SlurmExecutor` with its walltime
helpers (the same sbatch array scripts with bundling and afterany
dependencies, submitted through sbatch where it exists, else written for
inspection), whose elements run `python -m pyp_tpu_torch.cli worker`.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import random
import subprocess
import time
import traceback
from pathlib import Path

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

def get_total_seconds(walltime: str) -> int:
    """'D-HH:MM:SS' / 'HH:MM:SS' / 'MM:SS' -> seconds (the reference's
    slurm.get_total_seconds, system/slurm.py:576)."""
    days = 0
    if "-" in walltime:
        d, walltime = walltime.split("-", 1)
        days = int(d)
    parts = [int(p) for p in walltime.split(":")]
    while len(parts) < 3:
        parts.insert(0, 0)
    h, m, s = parts
    return ((days * 24 + h) * 60 + m) * 60 + s


def format_walltime(seconds: int) -> str:
    seconds = int(seconds)
    d, rem = divmod(seconds, 86400)
    h, rem = divmod(rem, 3600)
    m, s = divmod(rem, 60)
    return (f"{d}-{h:02d}:{m:02d}:{s:02d}" if d else f"{h:02d}:{m:02d}:{s:02d}")


def scale_walltime(base: str, n_items: int, bundle: int = 1,
                   safety: float = 1.5) -> str:
    """Per-array-element walltime: base covers one item; elements run
    `bundle` items serially (the reference scales its csp/swarm launch
    tiers the same way, system/slurm.py:446-540)."""
    per_item = get_total_seconds(base)
    return format_walltime(max(60, int(per_item * bundle * safety)))


class SlurmExecutor:
    """Emit (and optionally submit) sbatch scripts reproducing the
    reference's array-with-bundling shape. Python jobs are exported as
    `python -m pyp_tpu_torch.cli worker <payload.json>` invocations.

    submit_via: 'local' runs sbatch here; 'ssh' wraps it in
    `ssh <host> "bash --login -c ..."` (the reference's container-escape
    submission, system/singularity.py:73-133)."""

    def __init__(self, script_dir="swarm", queue="", walltime="24:00:00",
                 tasks: int = 1, memory_gb: int = 16, bundle: int = 1,
                 submit: bool = False, gres: str = "",
                 submit_via: str = "local", host: str = "",
                 account: str = "", qos: str = "", throttle: int = 0,
                 env_exports: dict | None = None, zombie_minutes: int = 0):
        self.script_dir = Path(script_dir)
        self.queue = queue
        self.walltime = walltime
        self.tasks = tasks
        self.memory_gb = memory_gb
        self.bundle = bundle
        self.submit = submit
        self.gres = gres
        self.submit_via = submit_via
        self.host = host
        self.account = account
        self.qos = qos
        # array concurrency throttle (sbatch --array=1-N%K): the
        # slurm_max_cpus / slurm_max_memory caps land here
        self.throttle = int(throttle)
        # env exported to every element (log level, trace profiling)
        self.env_exports = dict(env_exports or {})
        # reference slurm.zombie: sweep split scratch dirs idle longer
        # than this before starting work
        self.zombie_minutes = int(zombie_minutes)

    def write_array_script(self, stage: str, commands: list[str],
                           dependency: str | None = None) -> Path:
        """One array job; commands bundled `bundle` per element
        (streampyp/jobs.py:137-170 semantics)."""
        self.script_dir.mkdir(parents=True, exist_ok=True)
        cmd_file = self.script_dir / f"{stage}.swarm"
        cmd_file.write_text("\n".join(commands) + "\n")
        n = len(commands)
        n_elems = (n + self.bundle - 1) // self.bundle
        arr = f"1-{n_elems}"
        if self.throttle > 0:
            arr += f"%{max(1, self.throttle)}"
        lines = [
            "#!/bin/bash",
            f"#SBATCH --job-name={stage}",
            f"#SBATCH --array={arr}",
            f"#SBATCH --cpus-per-task={self.tasks}",
            f"#SBATCH --mem={self.memory_gb}G",
            f"#SBATCH --time={self.walltime}",
            f"#SBATCH --output={self.script_dir}/{stage}-%A_%a.out",
        ]
        if self.queue:
            lines.append(f"#SBATCH --partition={self.queue}")
        if self.account:
            lines.append(f"#SBATCH --account={self.account}")
        if self.qos:
            lines.append(f"#SBATCH --qos={self.qos}")
        if self.gres:
            lines.append(f"#SBATCH --gres={self.gres}")
        if dependency:
            lines.append(f"#SBATCH --dependency=afterany:{dependency}")
        lines.append("set -u")
        for k, v in self.env_exports.items():
            lines.append(f"export {k}={v}")
        if self.zombie_minutes > 0:
            # zombie sweep (reference slurm.zombie): clear split scratch
            # dirs idle longer than the timeout before starting work
            lines.append(
                "find ${TMPDIR:-/tmp} -maxdepth 1 -name 'pyp_tpu_*' "
                f"-mmin +{self.zombie_minutes} -exec rm -rf {{}} + "
                "2>/dev/null || true")
        lines += [
            f"START=$(( (SLURM_ARRAY_TASK_ID - 1) * {self.bundle} + 1 ))",
            f"END=$(( START + {self.bundle} - 1 ))",
            f'sed -n "${{START}},${{END}}p" {cmd_file} | while read -r cmd; do',
            '  eval "$cmd"',
            "done",
        ]
        path = self.script_dir / f"{stage}.sbatch"
        path.write_text("\n".join(lines) + "\n")
        return path

    def submit_command(self, script: Path) -> list[str]:
        """argv for the configured submission backend."""
        if self.submit_via == "ssh" and self.host:
            inner = f"sbatch --parsable {script.resolve()}"
            return ["ssh", self.host, f"bash --login -c '{inner}'"]
        return ["sbatch", "--parsable", str(script)]

    def sbatch(self, script: Path) -> str | None:
        """Submit and return the job id (None when sbatch is unavailable)."""
        if not self.submit:
            return None
        try:
            out = subprocess.run(
                self.submit_command(script),
                capture_output=True, text=True, check=True,
            )
            return out.stdout.strip().split(";")[0]
        except (FileNotFoundError, subprocess.CalledProcessError) as e:
            logger.warning("submission failed (%s); scripts left in %s", e,
                           self.script_dir)
            return None

    def run_swarm(self, stage: str, commands: list[str],
                  dependency: str | None = None) -> str | None:
        script = self.write_array_script(stage, commands, dependency)
        return self.sbatch(script)
