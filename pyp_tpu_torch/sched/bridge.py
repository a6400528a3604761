"""SLURM <-> pipeline bridge — the port's own copy of
pyp_tpu/sched/bridge.py: the same sbatch scripts and worker payloads,
whose elements run `python -m pyp_tpu_torch.cli worker <payload.json>`.

  * `select_executor(params)` — any CLI mode with `-slurm_queue`/
    `-slurm_host` (or `-slurm_submit`) routes through SLURM; everything
    else keeps the in-process LocalExecutor.
  * `submit_swarm(mode, items, params, argv)` — one array element per
    item, each re-invoking the worker narrowed to that item, plus a
    dependent merge element that re-runs the full mode (the stages are
    resume-aware, so the merge skips per-item work and reduces).
  * `submit_training` / `submit_daemon` — one sbatch for a training mode
    or for the streaming daemon.
  * `write_distributed_refine_script(params, n_procs)` — one sbatch over
    `n_procs` nodes, one rank per card; each rank execs the mode with
    PYP_TPU_COORDINATOR / PYP_TPU_NUM_PROCS / PYP_TPU_PROC_ID /
    PYP_TPU_LOCAL_RANK exported, so `parallel.init_distributed` joins one
    torch.distributed group over every rank.
"""

from __future__ import annotations

import json
import re
import shlex
import sys
from pathlib import Path

from pyp_tpu_torch.sched.executor import LocalExecutor, SlurmExecutor, scale_walltime
from pyp_tpu_torch.utils.log import get_logger

logger = get_logger("bridge")


def strip_slurm_flags(argv: list[str]) -> list[str]:
    """Remove -slurm_* flags (and their values) so a worker re-invocation
    doesn't re-route itself through the submitter."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
            continue
        if a.startswith("-slurm") or a.startswith("-no_slurm"):
            skip = "=" not in a and not _is_bool_flag(a)
            continue
        out.append(a)
    return out


def _is_bool_flag(flag: str) -> bool:
    from pyp_tpu_torch.config.schema import all_params

    name = flag.lstrip("-").removeprefix("no_")
    d = all_params().get(name)
    return d is not None and d.type is bool


def slurm_requested(params: dict) -> bool:
    import os

    # workers must execute, not re-submit (slurm_* params persist in the
    # project config, so argv stripping alone cannot prevent recursion)
    if os.environ.get("PYP_TPU_WORKER"):
        return False
    return bool(params.get("slurm_queue") or params.get("slurm_host")
                or params.get("slurm_submit"))


def select_executor(params: dict):
    """(kind, executor) — 'slurm' when any slurm_* selection param is set."""
    if slurm_requested(params):
        tasks = int(params.get("slurm_tasks") or 1)
        # reference memory model: flat slurm_memory wins; otherwise
        # memory_per_task x tasks (tabs.slurm.memory_per_task)
        mem = int(params.get("slurm_memory") or 0) or (
            int(params.get("slurm_memory_per_task") or 0) * tasks) or 16
        # array concurrency caps -> sbatch %K throttle
        throttle = 0
        if int(params.get("slurm_max_cpus") or 0) > 0:
            throttle = max(1, int(params["slurm_max_cpus"]) // max(tasks, 1))
        if int(params.get("slurm_max_memory") or 0) > 0:
            by_mem = max(1, int(params["slurm_max_memory"]) // max(mem, 1))
            throttle = min(throttle, by_mem) if throttle else by_mem
        level = str(params.get("slurm_verbose_level") or "info")
        if params.get("slurm_verbose") and level == "info":
            level = "debug"
        env = {}
        if level != "info":
            env["PYP_TPU_LOG_LEVEL"] = level
        if params.get("slurm_profile"):
            env["PYP_TPU_TRACE"] = "1"
        return "slurm", SlurmExecutor(
            script_dir=str(params.get("slurm_script_dir") or "swarm"),
            queue=str(params.get("slurm_queue") or ""),
            walltime=str(params.get("slurm_walltime") or "24:00:00"),
            tasks=tasks,
            memory_gb=mem,
            bundle=int(params.get("slurm_bundle_size") or 0)
            or int(params.get("slurm_bundle") or 1),
            submit=bool(params.get("slurm_submit")),
            gres=str(params.get("slurm_gres") or ""),
            submit_via="ssh" if params.get("slurm_host") else "local",
            host=str(params.get("slurm_host") or ""),
            account=str(params.get("slurm_account") or ""),
            qos=str(params.get("slurm_qos") or ""),
            throttle=throttle,
            env_exports=env,
            zombie_minutes=int(params.get("slurm_zombie") or 0),
        )
    return "local", LocalExecutor(
        max_workers=int(params.get("slurm_tasks") or 1))


def _payload(script_dir: Path, name: str, mode: str, argv: list[str]) -> Path:
    script_dir.mkdir(parents=True, exist_ok=True)
    p = script_dir / f"{name}.json"
    p.write_text(json.dumps({"mode": mode, "argv": argv}, indent=1))
    return p


def worker_command(payload: Path) -> str:
    return f"{shlex.quote(sys.executable)} -m pyp_tpu_torch.cli worker {shlex.quote(str(payload.resolve()))}"


def submit_training(mode: str, params: dict, argv: list[str]) -> dict:
    """Single sbatch for an NN training mode (sprtrain/tomotrain): the
    reference submits training to its gpu tier (system/slurm.py:446); here
    the tier is -slurm_train_walltime / -slurm_train_gres (e.g. tpu:1)."""
    ex = select_executor(params)[1]
    assert isinstance(ex, SlurmExecutor)
    ex.walltime = str(params.get("slurm_train_walltime")
                      or params.get("slurm_walltime") or "24:00:00")
    if params.get("slurm_train_gres"):
        ex.gres = str(params["slurm_train_gres"])
        if params.get("slurm_queue_gpu"):
            # accelerator jobs land on the GPU partition
            # (tabs.slurm.queue_gpu)
            ex.queue = str(params["slurm_queue_gpu"])
    sd = Path(ex.script_dir)
    payload = _payload(sd, f"{mode}_train", mode,
                       strip_slurm_flags(list(argv)))
    script = ex.write_array_script(mode, [worker_command(payload)])
    jid = ex.sbatch(script)
    return {"scripts": [str(script)], "job_ids": [j for j in (jid,) if j],
            "n_items": 1}


def submit_daemon(params: dict, argv: list[str]) -> dict:
    """Single long-running sbatch for the streaming session daemon (the
    reference submits streampyp's pyp_daemon as one scheduler job,
    stream/pyp_daemon.py) — resources come from the slurm daemon tier."""
    ex = select_executor(params)[1]
    assert isinstance(ex, SlurmExecutor)
    ex.walltime = str(params.get("slurm_daemon_walltime")
                      or params.get("slurm_walltime") or "7-00:00:00")
    if params.get("slurm_daemon_tasks"):
        ex.tasks = int(params["slurm_daemon_tasks"])
    if params.get("slurm_daemon_memory"):
        ex.memory_gb = int(params["slurm_daemon_memory"])
    elif params.get("slurm_daemon_memory_per_task"):
        ex.memory_gb = (int(params["slurm_daemon_memory_per_task"])
                        * max(ex.tasks, 1))
    if params.get("slurm_daemon_queue"):
        ex.queue = str(params["slurm_daemon_queue"])
    if params.get("slurm_daemon_account"):
        ex.account = str(params["slurm_daemon_account"])
    if params.get("slurm_daemon_gres"):
        ex.gres = str(params["slurm_daemon_gres"])
    sd = Path(ex.script_dir)
    payload = _payload(sd, "stream_daemon", "stream",
                       strip_slurm_flags(list(argv)))
    script = ex.write_array_script("streamdaemon",
                                   [worker_command(payload)])
    jid = ex.sbatch(script)
    return {"scripts": [str(script)],
            "job_ids": [j for j in (jid,) if j], "n_items": 1}


def submit_swarm(mode: str, items: list, params: dict, argv: list[str],
                 item_flag: str = "data_path") -> dict:
    """Emit (and optionally sbatch) the swarm array + dependent merge for a
    per-item mode. Each element re-invokes the SAME mode narrowed to one
    item via `-{item_flag} <path>` appended to the original argv (explicit
    flags win, config.params precedence), so per-item processing happens in
    the element and the dependent merge run finds it done and reduces.

    Returns {"scripts": [...], "job_ids": [...], "n_items": N}.
    """
    ex: SlurmExecutor = select_executor(params)[1]
    assert isinstance(ex, SlurmExecutor)
    # per-stage resource tiers (the reference's slurm task-type tiers,
    # system/slurm.py:446-540): these override the generic values for this
    # stage's array
    tiers = {
        "spr": {"walltime": "slurm_spr_walltime",
                "tasks": "slurm_spr_tasks", "memory": "slurm_spr_memory"},
        "tomo": {"walltime": "slurm_tomo_walltime",
                 "tasks": "slurm_tomo_tasks",
                 "memory": "slurm_tomo_memory"},
        "csp": {"walltime": "slurm_csp_walltime",
                "tasks": "slurm_csp_tasks", "memory": "slurm_csp_memory"},
        "classify3d": {"walltime": "slurm_class_walltime",
                       "tasks": "slurm_class_tasks",
                       "memory": "slurm_class_memory"},
        # class2d has its own reference tier, falling back to class_*
        "classify2d": {
            "walltime": ("slurm_class2d_walltime", "slurm_class_walltime"),
            "tasks": ("slurm_class2d_tasks", "slurm_class_tasks"),
            "memory": ("slurm_class2d_memory", "slurm_class_memory"),
            "memory_per_task": "slurm_class2d_memory_per_task",
            "queue": "slurm_class2d_queue",
            "account": "slurm_class2d_account",
            "gres": "slurm_class2d_gres"},
        # streaming daemon tier (tabs.slurm.daemon_*)
        "stream": {"walltime": "slurm_daemon_walltime",
                   "tasks": "slurm_daemon_tasks",
                   "memory": "slurm_daemon_memory",
                   "memory_per_task": "slurm_daemon_memory_per_task",
                   "queue": "slurm_daemon_queue",
                   "account": "slurm_daemon_account",
                   "gres": "slurm_daemon_gres"},
    }
    tier = tiers.get(mode, {"walltime": f"slurm_{mode}_walltime",
                            "tasks": f"slurm_{mode}_tasks",
                            "memory": f"slurm_{mode}_memory"})

    def tval(suffix):
        keys = tier.get(suffix) or ()
        for k in (keys,) if isinstance(keys, str) else keys:
            v = params.get(k)
            if v not in (None, "", 0, 0.0):
                return v
        return None

    tier_wt = str(tval("walltime") or "")
    if tval("tasks"):
        ex.tasks = int(tval("tasks"))
    if tval("memory"):
        ex.memory_gb = int(tval("memory"))
    elif tval("memory_per_task"):
        ex.memory_gb = int(tval("memory_per_task")) * max(ex.tasks, 1)
    if tval("queue"):
        ex.queue = str(tval("queue"))
    if tval("account"):
        ex.account = str(tval("account"))
    if tval("gres"):
        ex.gres = str(tval("gres"))
    sd = Path(ex.script_dir)
    argv = strip_slurm_flags(list(argv))  # workers must not re-submit
    commands = []
    for i, item in enumerate(items):
        path = str(item["path"]) if isinstance(item, dict) else str(item)
        payload = _payload(sd, f"{mode}_{i:05d}", mode,
                           list(argv) + [f"-{item_flag}", path])
        commands.append(worker_command(payload))
    script = jid = None
    if params.get("slurm_merge_only"):
        # merge-before-split resume (reference tabs.slurm.merge_only):
        # reduce whatever previous split runs produced, no new array
        logger.info("%s: merge_only set — skipping the %d-element array",
                    mode, len(items))
    else:
        ex.walltime = tier_wt or scale_walltime(
            str(params.get("slurm_walltime") or "4:00:00"), len(items),
            ex.bundle)
        script = ex.write_array_script(f"{mode}swarm", commands)
        jid = ex.sbatch(script)
    # dependent merge: full mode re-run (resume-aware -> reduce only)
    merge_payload = _payload(sd, f"{mode}_merge", mode, list(argv))
    ex.walltime = str(params.get("slurm_merge_walltime") or "48:00:00")
    if params.get("slurm_merge_tasks"):
        ex.tasks = int(params["slurm_merge_tasks"])
    if params.get("slurm_merge_memory"):
        ex.memory_gb = int(params["slurm_merge_memory"])
    elif params.get("slurm_merge_memory_per_task"):
        ex.memory_gb = (int(params["slurm_merge_memory_per_task"])
                        * max(ex.tasks, 1))
    if params.get("slurm_merge_queue"):
        ex.queue = str(params["slurm_merge_queue"])
    if params.get("slurm_merge_account"):
        ex.account = str(params["slurm_merge_account"])
    if params.get("slurm_merge_gres"):
        ex.gres = str(params["slurm_merge_gres"])
    merge_script = ex.write_array_script(
        f"{mode}merge", [worker_command(merge_payload)],
        dependency=jid)
    mjid = ex.sbatch(merge_script)
    logger.info("%s: emitted %d-element array + merge under %s%s",
                mode, len(items), sd,
                f" (job {jid} -> {mjid})" if jid else " (not submitted)")
    scripts = ([str(script)] if script else []) + [str(merge_script)]
    return {"scripts": scripts,
            "job_ids": [j for j in (jid, mjid) if j],
            "n_items": len(items)}


def ranks_per_node(params: dict) -> int:
    """Ranks per node of the distributed script: one per card, the count of
    a `gpu:N` (or `gpu:<type>:N`) in slurm_gres, else 1."""
    m = re.search(r"gpu(?::[^:,]+)?:(\d+)", str(params.get("slurm_gres") or ""))
    return max(1, int(m.group(1))) if m else 1


def write_distributed_refine_script(params: dict, n_procs: int,
                                    mode: str = "refine",
                                    argv: list[str] | None = None,
                                    port: int = 29500) -> Path:
    """Multi-node refinement: one sbatch over `n_procs` nodes, the group's
    env exported per rank (PYP_TPU_COORDINATOR from the first allocated
    node). `parallel.init_distributed` in cli.main picks these up before
    any device work, so the pipeline mesh spans every rank.

    The JAX package's script, but for two things: the module it runs
    (`pyp_tpu_torch.cli`), and the lines that place one rank per card — a
    JAX rank drives every chip of its host, a torch rank drives one card:
    `ranks_per_node` ranks on each node (`--ntasks`, `--ntasks-per-node`),
    each pinning the card of its SLURM_LOCALID (PYP_TPU_LOCAL_RANK)."""
    ex = select_executor(params)[1]
    sd = Path(ex.script_dir if isinstance(ex, SlurmExecutor) else "swarm")
    sd.mkdir(parents=True, exist_ok=True)
    payload = _payload(sd, f"{mode}_dist", mode, list(argv or []))
    per_node = ranks_per_node(params)
    lines = [
        "#!/bin/bash",
        f"#SBATCH --job-name={mode}dist",
        f"#SBATCH --nodes={n_procs}",
        f"#SBATCH --ntasks={n_procs * per_node}",
        f"#SBATCH --ntasks-per-node={per_node}",
        f"#SBATCH --cpus-per-task={int(params.get('slurm_tasks') or 1)}",
        f"#SBATCH --mem={int(params.get('slurm_memory') or 16)}G",
        f"#SBATCH --time={params.get('slurm_walltime') or '24:00:00'}",
        f"#SBATCH --output={sd}/{mode}dist-%j.out",
    ]
    if params.get("slurm_queue"):
        lines.append(f"#SBATCH --partition={params['slurm_queue']}")
    if params.get("slurm_gres"):
        lines.append(f"#SBATCH --gres={params['slurm_gres']}")
    lines += [
        "set -u",
        "COORD_HOST=$(scontrol show hostnames \"$SLURM_JOB_NODELIST\" | head -n1)",
        f"export PYP_TPU_COORDINATOR=\"$COORD_HOST:{port}\"",
        "export PYP_TPU_NUM_PROCS=$SLURM_NTASKS",
        # srun exports SLURM_PROCID and SLURM_LOCALID per rank; cli.main
        # reads them as PYP_TPU_PROC_ID and PYP_TPU_LOCAL_RANK
        "srun bash -c 'PYP_TPU_PROC_ID=$SLURM_PROCID "
        f"PYP_TPU_LOCAL_RANK=$SLURM_LOCALID {worker_command(payload)}'",
    ]
    path = sd / f"{mode}dist.sbatch"
    path.write_text("\n".join(lines) + "\n")
    logger.info("distributed %s script for %d nodes x %d ranks: %s", mode,
                n_procs, per_node, path)
    return path
