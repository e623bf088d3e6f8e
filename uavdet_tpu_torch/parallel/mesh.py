"""The device mesh and the placement of the model: ``uavdet_tpu/parallel/
mesh.py`` in torch, for the ``data`` and ``fsdp`` axes.

One process drives one device (``torch.distributed``); the mesh is a
``DeviceMesh`` over every rank, with the dimension names ``("data",
"fsdp")``. As in the JAX package the batch shards over both axes
(``BATCH_AXES``, the ZeRO convention): rank ``d * n_fsdp + f`` holds block
``d * n_fsdp + f`` of the global batch's rows.

``shard_model`` places the model:

* ``data`` only: ``DistributedDataParallel`` (parameters replicated, the
  gradients averaged in the backward);
* ``fsdp`` only: FSDP2 ``fully_shard`` on every block of the model (each
  element of a top-level ``ModuleList``, every other top-level child) and on
  the root;
* both: ``fully_shard`` on the 2-D mesh, HSDP: replicated over ``data``,
  sharded over ``fsdp``.

Deliberate deviation: FSDP2 shards dimension 0 of every parameter, where
the JAX package shards the last axis of kernels of 2^14 elements or more
(``mesh.py:158-160``). The arithmetic is the same, only the layout differs.

Every BatchNorm of the model gets the mesh's process group, so that its
training-mode statistics are over the global batch
(``parallel/batchnorm.py``).

``sp``, ``ep`` and ``pp`` are not ported yet; ``check_layout_supported``
refuses them, naming their ROADMAP items. The JAX refusal of fsdp x sp
answers an XLA miscompile and is not copied.
"""

import contextlib
import math

import torch
import torch.distributed as dist
from torch import nn

BATCH_AXES = ("data", "fsdp")

# the ROADMAP items of the axes that are not ported yet
NOT_PORTED = {
    "ep_devices": "ROADMAP.md queue 1 item 2 (ep: a tensor-parallel split of "
                  "the DyConv expert stack)",
    "sp_devices": "ROADMAP.md queue 1 item 3 (sp: a halo exchange for every "
                  "3x3 conv)",
    "pp_devices": "ROADMAP.md queue 1 item 4 (pp: the stage split of "
                  "parallel/pipeline.py)",
}


def check_layout_supported(sp: int = 1, ep: int = 1, pp: int = 1) -> None:
    """Raise for an axis the port has not ported (size above 1)."""
    for key, n in (("sp_devices", sp), ("ep_devices", ep),
                   ("pp_devices", pp)):
        if int(n or 1) > 1:
            raise ValueError(f"train.trainer.{key}={n}: the torch port "
                             f"trains over data x fsdp only; {key[:2]} is "
                             f"{NOT_PORTED[key]}")


def make_mesh(n_data: int, n_fsdp: int, device_type: str):
    """A ``("data", "fsdp")`` DeviceMesh of ``device_type`` ("cuda" or
    "cpu") over every rank of the running process group. The mesh must
    cover the world: the batch group of the BatchNorms and the loss is the
    whole group."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if n_data * n_fsdp != world:
        raise ValueError(f"a mesh of data {n_data} x fsdp {n_fsdp} must "
                         f"cover the {world} ranks of the process group")
    return init_device_mesh(device_type, (n_data, n_fsdp),
                            mesh_dim_names=BATCH_AXES)


def batch_group_size(mesh) -> int:
    """Number of ways the batch shards (data x fsdp)."""
    return math.prod(mesh[a].size() for a in BATCH_AXES)


def check_batch_divisible(batch_size: int, mesh) -> None:
    grp = batch_group_size(mesh)
    if batch_size % grp:
        raise ValueError(
            f"dataset.batch_size={batch_size} must be divisible by "
            f"data*fsdp={grp} (the batch shards over both mesh axes, the "
            "ZeRO convention of parallel.mesh.BATCH_AXES)")


def batch_group(mesh):
    """The process group over which the batch shards: every rank."""
    return None if mesh is None else dist.group.WORLD


def batch_index(mesh) -> int:
    """This rank's block of the batch: its position in the flattened
    mesh."""
    d, f = mesh.get_coordinate()
    return d * mesh["fsdp"].size() + f


def row_block(index: int, groups: int, n: int) -> range:
    """Block ``index`` of ``groups`` contiguous blocks of ``n`` rows, each
    ceil(n / groups) long but the last ones (the JAX split where ``groups``
    divides ``n``)."""
    k = -(-n // groups)
    return range(min(n, index * k), min(n, (index + 1) * k))


def _blocks(model: nn.Module):
    for child in model.children():
        subs = child if isinstance(child, nn.ModuleList) else [child]
        for m in subs:
            if any(p.requires_grad for p in m.parameters()):
                yield m


def shard_model(model: nn.Module, mesh, fsdp: bool | None = None
                ) -> nn.Module:
    """-> the model placed on the mesh (see the module docstring): a DDP
    wrapper of ``model`` where fsdp is 1, else ``model`` itself made an
    FSDP2 module in place (``fsdp`` True asks for FSDP2 on an fsdp axis of
    one rank too). Every port BatchNorm2d of it gets the mesh's process
    group."""
    from ..models.layers import BatchNorm2d
    group = batch_group(mesh)
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.process_group = group
    if not (mesh["fsdp"].size() > 1 if fsdp is None else fsdp):
        from torch.nn.parallel import DistributedDataParallel
        dev = next(model.parameters()).device
        return DistributedDataParallel(
            model, device_ids=[dev] if dev.type == "cuda" else None,
            broadcast_buffers=False)
    from torch.distributed.fsdp import fully_shard
    with torch.no_grad():   # FSDP2 takes contiguous parameters only (not
        for p in model.parameters():   # the card's channels_last convs)
            if not p.is_contiguous():
                p.data = p.data.contiguous()
    sub = mesh if mesh["data"].size() > 1 else mesh["fsdp"]
    for m in _blocks(model):
        fully_shard(m, mesh=sub)
    fully_shard(model, mesh=sub)
    return model


def unwrap(model: nn.Module) -> nn.Module:
    """The module inside a DDP wrapper; any other module as it is."""
    return model.module if is_ddp(model) else model


def is_ddp(model) -> bool:
    from torch.nn.parallel import DistributedDataParallel
    return isinstance(model, DistributedDataParallel)


def is_fsdp(model) -> bool:
    from torch.distributed.fsdp import FSDPModule
    return isinstance(model, FSDPModule)


@contextlib.contextmanager
def gradient_sync(model: nn.Module, sync: bool):
    """Around one microbatch's forward and backward: ``sync`` False keeps
    the gradient on the rank (DDP's ``no_sync``, FSDP2's
    ``set_requires_gradient_sync(False)``), True reduces it at the end of
    the backward."""
    if is_ddp(model) and not sync:
        with model.no_sync():
            yield
        return
    if is_fsdp(model):
        model.set_requires_gradient_sync(sync)
    yield


@torch.no_grad()
def copy_full_weights(src: nn.Module, dst: nn.Module) -> None:
    """``dst`` (a plain module of the same structure) takes ``src``'s
    parameters, all-gathered where FSDP2 shards them, and its buffers. A
    collective: every rank calls it."""
    from torch.distributed.tensor import DTensor
    src = unwrap(src)
    mine = dict(dst.named_parameters())
    for name, p in src.named_parameters():
        full = p.full_tensor() if isinstance(p, DTensor) else p
        mine[name].copy_(full)
    bufs = dict(dst.named_buffers())
    for name, b in src.named_buffers():
        bufs[name].copy_(b)


def all_gather_rows(local: torch.Tensor, counts, group=None) -> torch.Tensor:
    """The rows of every rank in rank order: ``local`` (n_r, ...) where rank
    r holds ``counts[r]`` rows; padded to the largest count for the
    collective and trimmed after. Every rank calls it, with zero rows
    too."""
    k = max(counts)
    pad = local.new_zeros((k,) + tuple(local.shape[1:]))
    pad[:local.shape[0]] = local
    parts = [torch.empty_like(pad) for _ in counts]
    dist.all_gather(parts, pad, group=group)
    return torch.cat([p[:n] for p, n in zip(parts, counts)])
