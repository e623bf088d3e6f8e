"""The ``ep`` axis: the expert stacks of the dynamic convs sliced over the
ranks of an ``ep`` group, the port's counterpart of the JAX package's
``_param_spec`` (``uavdet_tpu/parallel/mesh.py:141-161``).

The stacks are ``DyConvModule.weights`` (E, O, I, k, k) and DySOEM's
``Experts`` (``kernel`` (k, k, I, E*O), ``bias`` (E*O,)). Each is viewed
along its flattened E*O axis, expert-major, the JAX package's
stacked-channel axis: rank i of ``n`` keeps the contiguous slice
``[i * E*O/n, (i + 1) * E*O/n)`` as its parameter (with its optimizer
state, which the optimizer builds over the slice), where ``n`` divides
E*O; otherwise the stack stays whole on every rank, as ``_param_spec``
leaves it replicated. A slice may cut through an expert (DySOEM's E = 3
under ep 2).

Forward of a sliced module, per microbatch (``mix_slices``):

1. ``all_gather`` the ``ep`` group's attentions, (B_group, E), each rank
   its own rows (the batch shards over ``ep`` too);
2. mix this rank's slice for every row of the group: partial per-sample
   kernels (B_group, O, ...), zero where the slice holds no expert term;
3. sum the partial kernels over the group and keep this rank's rows (an
   all-reduce and a slice: gloo has no reduce-scatter);
4. convolve as without ``ep``.

The collectives are autograd Functions (the backward of 1 is an
all-reduce and a slice, of 3 an all-reduce of the rows' gradients placed
at their rows), so after the backward a slice's gradient holds the terms of
every row of its ``ep`` group. ``reduce_expert_grads`` then sums it over
the ranks that hold the same slice (``mesh.same_slice_group``) and divides
by the world, which is what DDP does for the other parameters: DDP and
FSDP2 are told to leave the slices alone (``shard_model``).

``full_expert_tensor`` gathers a slice back into the whole stack
(checkpoints, ``copy_full_weights``); ``cut_expert_tensor`` cuts a whole
stack into this rank's slice.
"""

from typing import NamedTuple

import torch
import torch.distributed as dist
from torch import nn


class ExpertSlice(NamedTuple):
    """Where a parameter's slice lies in its stack: flat indices [lo, hi)
    of E*O on ``axis`` of the slice, rank ``index`` of ``n`` in
    ``group``."""
    group: object
    index: int
    n: int
    lo: int
    hi: int
    axis: int
    n_experts: int
    n_out: int
    full_shape: tuple


def _stacks(model: nn.Module):
    """(module, parameter name, flat axis, E, O) of every expert stack."""
    from ..models.dysoem_simfpn import DynamicSOEM
    from ..models.layers import DyConvModule
    for m in model.modules():
        if isinstance(m, DyConvModule):
            e, o = m.weights.shape[:2]
            yield m, "weights", 0, e, o
        elif isinstance(m, DynamicSOEM):
            e, o = m.num_dy_conv, m.out_channels
            yield m.experts, "kernel", 3, e, o
            yield m.experts, "bias", 0, e, o


def _flat(t: torch.Tensor, axis: int, e: int, o: int) -> torch.Tensor:
    """The stack with its E*O axis at ``axis`` (DyConv's (E, O, ...) joined
    into one)."""
    return t.reshape((e * o,) + tuple(t.shape[2:])) if axis == 0 and \
        t.shape[:2] == (e, o) else t


@torch.no_grad()
def shard_experts(model: nn.Module, mesh) -> None:
    """Cut every expert stack of ``model`` whose E*O the ``ep`` axis divides
    into this rank's slice, in place (see the module docstring). The
    parameter is replaced by the slice, which carries ``ep_slice``."""
    from .mesh import ep_group
    group = ep_group(mesh)
    if group is None:
        return
    i, n = dist.get_rank(group), dist.get_world_size(group)
    for m, name, axis, e, o in list(_stacks(model)):
        full = getattr(m, name)
        if (e * o) % n or getattr(full, "ep_slice", None) is not None:
            continue
        k = e * o // n
        info = ExpertSlice(group, i, n, i * k, (i + 1) * k, axis, e, o,
                           tuple(full.shape))
        part = _flat(full, axis, e, o).narrow(axis, info.lo, k).clone()
        p = nn.Parameter(part, requires_grad=full.requires_grad)
        p.ep_slice = info
        setattr(m, name, p)


def expert_params(model: nn.Module) -> list:
    """The parameters of ``model`` that are expert slices, in order."""
    return [p for p in model.parameters()
            if getattr(p, "ep_slice", None) is not None]


def full_expert_tensor(p: torch.Tensor, info: ExpertSlice | None = None
                       ) -> torch.Tensor:
    """The whole stack of slice ``p`` (or of a tensor shaped as it, such as
    its optimizer state, with ``info``): an all-gather over its ``ep``
    group, which every rank calls."""
    info = info or p.ep_slice
    parts = [torch.empty_like(p.detach().contiguous()) for _ in
             range(info.n)]
    dist.all_gather(parts, p.detach().contiguous(), group=info.group)
    return torch.cat(parts, dim=info.axis).reshape(info.full_shape)


def cut_expert_tensor(full: torch.Tensor, info: ExpertSlice
                      ) -> torch.Tensor:
    """This rank's slice of a whole stack ``full``."""
    return _flat(full, info.axis, info.n_experts, info.n_out).narrow(
        info.axis, info.lo, info.hi - info.lo).clone()


@torch.no_grad()
def reduce_expert_grads(model: nn.Module, mesh) -> None:
    """After the backward of an update's last microbatch: every slice's
    gradient summed over the ranks that hold the same slice and divided by
    the world (the average DDP takes of the other parameters)."""
    from .mesh import same_slice_group
    group = same_slice_group(mesh)
    world = dist.get_world_size()
    for p in expert_params(model):
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        dist.all_reduce(p.grad, group=group)
        p.grad.div_(world)


def _counts(b: int, group, device) -> list:
    """The rows of every rank of ``group``."""
    mine = torch.tensor([b], device=device)
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size(
        group))]
    dist.all_gather(parts, mine, group=group)
    return [int(c) for c in torch.cat(parts).tolist()]


class _GatherRows(torch.autograd.Function):
    """(b_r, ...) on each rank -> (sum of b, ...) of every rank in rank
    order; backward: the sum over the group of the gradient, this rank's
    rows."""

    @staticmethod
    def forward(ctx, x, counts, group):
        ctx.counts, ctx.group = counts, group
        k = max(counts)
        pad = x.new_zeros((k,) + tuple(x.shape[1:]))
        pad[:x.shape[0]] = x
        parts = [torch.empty_like(pad) for _ in counts]
        dist.all_gather(parts, pad, group=group)
        return torch.cat([p[:n] for p, n in zip(parts, counts)])

    @staticmethod
    def backward(ctx, dy):
        g = dy.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        r = dist.get_rank(ctx.group)
        lo = sum(ctx.counts[:r])
        return g[lo:lo + ctx.counts[r]], None, None


class _SumToOwner(torch.autograd.Function):
    """(sum of b, ...) partials on each rank -> the sum over the group,
    this rank's rows; backward: every rank's row gradients, each at its
    rows (an all-reduce of zero-padded rows)."""

    @staticmethod
    def forward(ctx, x, counts, group):
        ctx.counts, ctx.group = counts, group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        r = dist.get_rank(group)
        lo = sum(counts[:r])
        return y[lo:lo + counts[r]]

    @staticmethod
    def backward(ctx, dy):
        r = dist.get_rank(ctx.group)
        lo = sum(ctx.counts[:r])
        g = dy.new_zeros((sum(ctx.counts),) + tuple(dy.shape[1:]))
        g[lo:lo + ctx.counts[r]] = dy
        dist.all_reduce(g, group=ctx.group)
        return g, None, None


def _mix(attn: torch.Tensor, w: torch.Tensor, info: ExpertSlice
         ) -> torch.Tensor:
    """(B, E) attentions and a slice ``w`` (flat axis at ``info.axis``) ->
    the partial mixed kernels (B, O, ...rest) of the slice's expert terms,
    where ``rest`` are w's other axes in order."""
    wf = w.movedim(info.axis, 0)
    o = info.n_out
    dtype = torch.promote_types(attn.dtype, w.dtype)
    out = None
    for e in range(info.lo // o, -(-info.hi // o)):
        j0, j1 = max(info.lo, e * o), min(info.hi, (e + 1) * o)
        # under autocast the einsum's dtype (bf16), as the unsliced mix's
        piece = torch.einsum("b,j...->bj...", attn[:, e].to(dtype),
                             wf[j0 - info.lo:j1 - info.lo].to(dtype))
        if out is None:
            out = piece.new_zeros((attn.shape[0], o)
                                  + tuple(piece.shape[2:]))
        idx = torch.arange(j0 - e * o, j1 - e * o, device=w.device)
        out = out.index_add(1, idx, piece)
    return out


def mix_slices(attn: torch.Tensor, slices) -> list:
    """The per-sample mixed kernels of this rank's rows from expert slices:
    ``attn`` (b, E) this rank's attentions, ``slices`` parameters that carry
    ``ep_slice`` (one ``ep`` group, one E and O). -> for each slice, (b, O,
    ...rest) (rest: the slice's other axes in order), summed over the
    group's slices. Every rank of the group calls it, with its own rows
    (zero too); one all-gather of the attentions and one all-reduce of all
    the partial kernels together."""
    info = slices[0].ep_slice
    counts = _counts(attn.shape[0], info.group, attn.device)
    if not sum(counts):
        return [_mix(attn, w, w.ep_slice) for w in slices]
    attn_all = _GatherRows.apply(attn, counts, info.group)
    parts = [_mix(attn_all, w, w.ep_slice) for w in slices]
    flat = torch.cat([p.reshape(p.shape[0], -1) for p in parts], dim=1)
    mine = _SumToOwner.apply(flat, counts, info.group)
    out, at = [], 0
    for p in parts:
        n = p[0].numel()
        out.append(mine[:, at:at + n].reshape((mine.shape[0],)
                                              + tuple(p.shape[1:])))
        at += n
    return out

