"""Process start-up and per-rank batches: ``uavdet_tpu/parallel/
multihost.py`` in torch.

``init_multihost`` starts the ``torch.distributed`` process group, once
per process: from the environment of ``torch.distributed.run`` (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), or from an explicit
``coordinator`` ("host:port", a TCP store), ``num_processes`` and
``process_id``. ``backend_for`` picks the backend: NCCL where each process
on the host drives a card of its own, gloo on the CPU and where processes
share a card (NCCL refuses two ranks on one device).

``local_batch_rows`` gives the rows of the global batch that this rank
holds, for ``DataPipeline.set_local_rows``; ``shard_host_batch`` slices them
out of a global host batch. Where the JAX package zero-fills the other rows
for ``jax.make_array_from_callback``, a rank here holds its own rows only.
"""

import os

import torch
import torch.distributed as dist

from .mesh import batch_group_size, batch_index, row_block


def local_device(device="cuda") -> torch.device:
    """The device of this process: for "cuda" without an index, card
    ``LOCAL_RANK`` modulo the cards visible (two ranks on one card share
    it); any other device as it is."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        n = torch.cuda.device_count()
        index = int(os.environ.get("LOCAL_RANK", 0)) % max(n, 1)
        return torch.device("cuda", index)
    return device


def backend_for(device, local_world: int) -> str:
    """The process group's backend for ``local_world`` processes on this
    host, each driving ``device``: gloo on the CPU and where they outnumber
    the visible cards (two ranks sharing a card), else NCCL."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def init_multihost(coordinator: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None, device="cuda") -> bool:
    """Start the process group (idempotent). -> whether a group runs: False
    where none is running, no ``coordinator`` is given and the environment
    names no ``WORLD_SIZE``. The processes on this host are
    ``LOCAL_WORLD_SIZE`` (``torch.distributed.run`` sets it), else all of
    them (``backend_for``)."""
    if dist.is_initialized():
        return True
    if coordinator is not None:
        world = int(num_processes)
    elif "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
    else:
        return False
    backend = backend_for(device, int(os.environ.get("LOCAL_WORLD_SIZE",
                                                     world)))
    if coordinator is None:
        dist.init_process_group(backend)
        return True
    addr = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=addr, world_size=world,
                            rank=int(process_id))
    return True


def mesh_from_env(device="cuda"):
    """The data mesh over the ranks of ``torch.distributed.run`` (or of a
    running process group), for the entry points that detect: None where
    one process runs."""
    from .mesh import make_mesh
    if not init_multihost(device=device) or dist.get_world_size() == 1:
        return None
    return make_mesh(dist.get_world_size(),
                     device_type=torch.device(device).type)


def is_writer() -> bool:
    """Whether this process writes the outputs: rank 0, or the only
    process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def local_batch_rows(mesh, batch_size: int) -> frozenset:
    """The rows of a global batch of ``batch_size`` that this rank holds:
    its block over data x fsdp x ep (the ranks of one ``sp`` group hold the
    same rows, each its band of their frames' rows)."""
    return frozenset(row_block(batch_index(mesh), batch_group_size(mesh),
                               batch_size))


def local_rows_of(rows, n: int) -> list:
    """``rows`` of a global batch that has ``n`` rows (a short last batch
    has fewer than ``batch_size``), in order."""
    return sorted(r for r in rows if r < n)


def shard_host_batch(batch, rows):
    """This rank's rows of a global host batch (any NamedTuple of arrays or
    tensors with the batch first)."""
    idx = local_rows_of(rows, len(batch[0]))
    lo, hi = (idx[0], idx[-1] + 1) if idx else (0, 0)
    if idx == list(range(lo, hi)):
        return type(batch)(*(t[lo:hi] for t in batch))
    return type(batch)(*(t[idx] for t in batch))
