"""The device mesh and the placement of the model: ``uavdet_tpu/parallel/
mesh.py`` in torch, for the ``data``, ``fsdp``, ``sp`` and ``ep`` axes.

One process drives one device (``torch.distributed``); the mesh is a
``DeviceMesh`` over every rank, with the dimension names ``("data",
"fsdp", "sp", "ep")`` in that order (rank ``((d * F + f) * S + s) * E +
e``). As in the JAX package the batch shards over every axis but ``sp``
(``BATCH_AXES``, the ZeRO convention): a rank holds block ``(d * F + f) *
E + e`` of the global batch's rows (``batch_index``), and the ranks of one
``sp`` group hold the same rows, each its band of the image's rows
(``parallel/spatial.py``).

``shard_model`` places the model:

* ``data`` only: ``DistributedDataParallel`` (parameters replicated, the
  gradients averaged in the backward over every rank);
* ``fsdp`` above 1: FSDP2 ``fully_shard`` on every block of the model (each
  element of a top-level ``ModuleList``, every other top-level child) and on
  the root; sharded over ``fsdp`` and, where ``data``, ``sp`` or ``ep`` has
  more than one rank, replicated over them (HSDP on a 2-D mesh of
  (data x sp x ep, fsdp));
* ``sp`` above 1: every conv of the model takes the ``sp`` group
  (``spatial.set_sp_group``): a 3x3 conv exchanges its halo rows;
* ``ep`` above 1: the expert stacks are cut into slices over ``ep``
  (``parallel/experts.py``), which neither DDP nor FSDP2 manages: their
  gradients are summed over the ranks that hold the same slice
  (``same_slice_group``) after the backward. ``ep`` takes precedence over
  ``fsdp``, as in the JAX ``_param_spec``.

Every BatchNorm of the model gets the world's process group, so that its
training-mode statistics are over the global batch (``parallel/
batchnorm.py``): the rows of every rank, the ``sp`` bands included.

Deliberate deviations: FSDP2 shards dimension 0 of every parameter, where
the JAX package shards the last axis of kernels of 2^14 elements or more
(``mesh.py:158-160``); the arithmetic is the same, only the layout differs.
The JAX refusal of fsdp x sp answers an XLA miscompile and is not copied:
FSDP2 gathers whole parameters before each use. ``pp`` is one process over
its stage devices (``parallel/pipeline.py``), on no mesh.
"""

import contextlib
import math

import torch
import torch.distributed as dist
from torch import nn

AXES = ("data", "fsdp", "sp", "ep")
BATCH_AXES = ("data", "fsdp", "ep")


def check_layout_supported(sp: int = 1, ep: int = 1, pp: int = 1) -> None:
    """Raise for an axis size below 1. Every axis of the JAX package is
    ported, in any composition it takes: ``sp`` and ``ep`` with data and
    fsdp here, ``pp`` alone (``parallel/pipeline.py``; the Trainer refuses
    it with fsdp, sp or ep, as the JAX trainer does)."""
    for key, n in (("sp_devices", sp), ("ep_devices", ep),
                   ("pp_devices", pp)):
        if int(n or 1) < 1:
            raise ValueError(f"train.trainer.{key}={n} must be at least 1")


def make_mesh(n_data: int, n_fsdp: int = 1, n_sp: int = 1, n_ep: int = 1,
              device_type: str = "cuda"):
    """A ``("data", "fsdp", "sp", "ep")`` DeviceMesh of ``device_type``
    ("cuda" or "cpu") over every rank of the running process group. The
    mesh must cover the world: the batch group of the BatchNorms and the
    loss is the whole group. A collective: every rank calls it. Besides
    the DeviceMesh's own groups (one per axis) it makes the groups of the
    ranks that hold the same expert slice (the same ``ep`` coordinate),
    read by ``same_slice_group``."""
    from torch.distributed.device_mesh import init_device_mesh
    sizes = tuple(int(n) for n in (n_data, n_fsdp, n_sp, n_ep))
    world = dist.get_world_size()
    if math.prod(sizes) != world:
        raise ValueError(
            "a mesh of " + " x ".join(f"{a} {n}" for a, n in zip(AXES, sizes))
            + f" must cover the {world} ranks of the process group")
    mesh = init_device_mesh(device_type, sizes, mesh_dim_names=AXES)
    mesh.same_slice = None
    if n_ep > 1:
        ranks = torch.arange(world).reshape(-1, n_ep)
        for e in range(n_ep):   # every rank makes every group, in order
            g = dist.new_group(ranks[:, e].tolist())
            if e == mesh.get_coordinate()[3]:
                mesh.same_slice = g
    return mesh


def axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh[axis].size()


def coordinate(mesh, rank: int | None = None) -> tuple:
    """(data, fsdp, sp, ep) of ``rank`` (this rank's where None)."""
    if rank is None:
        return tuple(mesh.get_coordinate())
    out = []
    for a in reversed(AXES):
        rank, c = divmod(rank, mesh[a].size())
        out.append(c)
    return tuple(reversed(out))


def batch_group_size(mesh) -> int:
    """Number of ways the batch shards (data x fsdp x ep)."""
    return math.prod(mesh[a].size() for a in BATCH_AXES)


def check_batch_divisible(batch_size: int, mesh) -> None:
    grp = batch_group_size(mesh)
    if batch_size % grp:
        raise ValueError(
            f"dataset.batch_size={batch_size} must be divisible by "
            f"data*fsdp*ep={grp} (the batch shards over every axis but sp, "
            "the ZeRO convention of parallel.mesh.BATCH_AXES)")


def batch_group(mesh):
    """The process group of the BatchNorms and the loss's metrics: every
    rank (the sp ranks of a sample each hold a band of its rows)."""
    return None if mesh is None else dist.group.WORLD


def batch_index(mesh, rank: int | None = None) -> int:
    """The block of the batch that ``rank`` (this rank where None) holds:
    its place on the data x fsdp x ep axes, row-major."""
    d, f, _, e = coordinate(mesh, rank)
    return (d * mesh["fsdp"].size() + f) * mesh["ep"].size() + e


def sp_group(mesh):
    """This rank's ``sp`` group, or None where ``sp`` has one rank."""
    return None if axis_size(mesh, "sp") == 1 else mesh["sp"].get_group()


def ep_group(mesh):
    """This rank's ``ep`` group, or None where ``ep`` has one rank."""
    return None if axis_size(mesh, "ep") == 1 else mesh["ep"].get_group()


def same_slice_group(mesh):
    """The ranks that hold the same expert slices as this one (the same
    ``ep`` coordinate), or None where ``ep`` has one rank."""
    return getattr(mesh, "same_slice", None)


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


def _fsdp_mesh(mesh):
    """The FSDP2 mesh: ``fsdp`` alone, or (replicate, fsdp) with the other
    three axes flattened into replicate (a collective where it is made)."""
    rep = mesh.size() // mesh["fsdp"].size()
    if rep == 1:
        return mesh["fsdp"]
    from torch.distributed.device_mesh import DeviceMesh
    ranks = mesh.mesh.permute(0, 2, 3, 1).reshape(rep, mesh["fsdp"].size())
    return DeviceMesh(mesh.device_type, ranks,
                      mesh_dim_names=("replicate", "fsdp"))


def shard_model(model: nn.Module, mesh, fsdp: bool | None = None
                ) -> nn.Module:
    """-> the model placed on the mesh (see the module docstring): a DDP
    wrapper of ``model`` where fsdp is 1, else ``model`` itself made an
    FSDP2 module in place (``fsdp`` True asks for FSDP2 on an fsdp axis of
    one rank too). Every port BatchNorm2d of it gets the mesh's process
    group, every conv the ``sp`` group, and with ``ep`` the expert stacks
    are cut into this rank's slices."""
    from ..models.layers import BatchNorm2d
    from .experts import expert_params, shard_experts
    from .spatial import set_sp_group
    group = batch_group(mesh)
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.process_group = group
    set_sp_group(model, sp_group(mesh))
    shard_experts(model, mesh)
    slices = expert_params(model)
    if not (mesh["fsdp"].size() > 1 if fsdp is None else fsdp):
        from torch.nn.parallel import DistributedDataParallel
        names = {id(p): n for n, p in model.named_parameters()}
        DistributedDataParallel._set_params_and_buffers_to_ignore_for_model(
            model, [names[id(p)] for p in slices])
        dev = next(model.parameters()).device
        return DistributedDataParallel(
            model, device_ids=[dev] if dev.type == "cuda" else None,
            broadcast_buffers=False)
    from torch.distributed.fsdp import fully_shard
    with torch.no_grad():   # FSDP2 takes contiguous parameters only (not
        for p in model.parameters():   # the card's channels_last convs)
            if not p.is_contiguous():
                p.data = p.data.contiguous()
    sub = _fsdp_mesh(mesh)
    ignored = set(slices) or None
    for m in _blocks(model):
        fully_shard(m, mesh=sub, ignored_params=ignored)
    fully_shard(model, mesh=sub, ignored_params=ignored)
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
    parameters, all-gathered where FSDP2 shards them or ``ep`` slices them,
    and its buffers. A collective: every rank calls it."""
    from torch.distributed.tensor import DTensor
    from .experts import full_expert_tensor
    src = unwrap(src)
    mine = dict(dst.named_parameters())
    for name, p in src.named_parameters():
        if isinstance(p, DTensor):
            full = p.full_tensor()
        elif getattr(p, "ep_slice", None) is not None:
            full = full_expert_tensor(p)
        else:
            full = p
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
