"""Several ranks, one card each: the process group, the mesh the pipelines
split their rows over, and the collective merges — the torch port of
pyp_tpu/parallel.

One rank drives one device (a JAX process drives every device of its
host). `init_distributed` joins the group the scheduler's environment
describes; `pipeline_mesh` is the mesh `pipeline.refine` and
`pipeline.csp` split their work over; rank 0 alone writes project files
(`is_writer`), and the other ranks wait at `barrier` where a later step
reads what it wrote.
"""

import os
import socket
from datetime import timedelta

from pyp_tpu_torch.parallel.spmd import (  # noqa: F401
    Mesh,
    csp_refine_batch_sharded,
    distributed,
    make_mesh,
    reconstruct_sharded,
    sharded_accumulate,
    sharded_accumulate_matrices,
    sharded_reconstruct,
    sharded_refine_batch,
    sharded_refine_step,
)
from pyp_tpu_torch.utils.log import get_logger, set_rank

logger = get_logger("parallel")


def pipeline_mesh(params: dict | None = None, device="cuda"):
    """The mesh the production pipelines split over: every rank of the
    group on a ("data", "model") mesh when the group has two ranks or
    more, else None (the single-device batch loop). parallel_data /
    parallel_model set the axis sizes (0 = the data axis takes every rank
    the model axis leaves). Disable with PYP_TPU_DISABLE_SPMD=1."""
    if os.environ.get("PYP_TPU_DISABLE_SPMD") == "1":
        return None
    import torch.distributed as dist

    if not distributed() or dist.get_world_size() < 2:
        return None
    params = params or {}
    model = max(1, int(params.get("parallel_model") or 1))
    data = int(params.get("parallel_data") or 0)
    n = data * model if data > 0 else None
    return make_mesh(n_devices=n, model=model, device=device)


def _card_identity(index: int) -> str:
    import torch

    props = torch.cuda.get_device_properties(index)
    card = getattr(props, "uuid", None) or getattr(props, "pci_bus_id", None)
    return f"{socket.gethostname()}:{card if card is not None else index}"


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device="cuda") -> bool:
    """Join the process group the scheduler exported: PYP_TPU_COORDINATOR
    (host:port of rank 0), PYP_TPU_NUM_PROCS and PYP_TPU_PROC_ID when the
    arguments are omitted, and PYP_TPU_LOCAL_RANK (the rank's index on its
    host) to pin its card, `torch.cuda.set_device(local_rank % cards)`.
    `device`: "cuda" (the default; raises without a card) or "cpu".
    Returns True when a group was joined (or already was), False for a
    single-process run.

    Backend: NCCL when each rank has a card of its own; gloo when ranks
    share a card (NCCL refuses two ranks on one device) or run on the CPU.
    The ranks tell each other their cards through the rendezvous store
    before the group starts. Under gloo the collectives copy to the host
    and back; the compute stays on the card. A failed rendezvous or
    `init_process_group` raises: nothing falls back to one process."""
    coordinator = coordinator or os.environ.get("PYP_TPU_COORDINATOR")
    if not coordinator:
        return False
    import torch
    import torch.distributed as dist

    from pyp_tpu_torch import resolve_device

    if dist.is_initialized():
        return True
    world = int(num_processes or os.environ.get("PYP_TPU_NUM_PROCS", 1))
    rank = int(process_id or os.environ.get("PYP_TPU_PROC_ID", 0))
    dev = resolve_device(device)
    ident = "cpu"
    if dev.type == "cuda":
        local = int(os.environ.get("PYP_TPU_LOCAL_RANK") or 0)
        index = dev.index if dev.index is not None else (
            local % torch.cuda.device_count())
        torch.cuda.set_device(index)
        ident = _card_identity(index)
    host, port = coordinator.rsplit(":", 1)
    timeout = timedelta(minutes=10)
    store = dist.TCPStore(host, int(port), world, rank == 0, timeout=timeout)
    store.set(f"card/{rank}", ident)
    cards = [store.get(f"card/{r}").decode() for r in range(world)]
    backend = ("nccl" if dev.type == "cuda" and len(set(cards)) == world
               else "gloo")
    dist.init_process_group(backend, store=store, world_size=world,
                            rank=rank, timeout=timeout)
    set_rank(rank, world)
    logger.info("joined the group at %s: rank %d of %d on %s (%s), "
                "backend %s", coordinator, rank, world, ident, dev, backend)
    return True


def is_writer() -> bool:
    """True where this process writes project files: a single-process run,
    or rank 0 of the group."""
    import torch.distributed as dist

    return not distributed() or dist.get_rank() == 0


def barrier():
    """Wait for every rank of the group (nothing in a single-process run)."""
    import torch.distributed as dist

    if distributed():
        dist.barrier()
