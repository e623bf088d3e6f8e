"""Optimizers and schedules: ``uavdet_tpu/training/optim.py`` in torch.

The JAX package builds one optax chain,
``MultiSteps(chain(clip_by_global_norm, sgd | adam), every_k=grad_batches)``
with the learning rate as a schedule of the update count. In torch the same
pieces are an optimizer, a scheduler and ``update``:

* SGD + momentum: ``torch.optim.SGD`` without dampening is optax's ``trace``
  form (v = mu v + g, p -= lr v); Adam with torch's defaults is optax's.
* CyclicLR 'triangular2' (base lr/10, max lr, step_size_up 4000, the
  amplitude halved each cycle) as a ``LambdaLR`` over the update count, so
  that no momentum is cycled (optax cycles none). With ``steps_per_epoch``
  it sees ``update // steps_per_epoch``, the epoch.
* Accumulation: the step backpropagates each microbatch's loss / k into the
  gradients, which sums to the mean gradient that ``MultiSteps`` takes, and
  ``update`` steps the optimizer once every k microbatches.
* Clipping by the global norm of that mean gradient, right before the
  update, as optax's ``clip_by_global_norm`` inside the chain (over
  FSDP2's shards, ``ep``'s expert slices and ``pp``'s stage devices, the
  whole model's norm).
"""

import math
from typing import Sequence

import torch

from ..utils.datatypes import TrainState


def cyclic_triangular2(base_lr: float, max_lr: float,
                       step_size_up: int = 4000):
    """``CyclicLR(mode='triangular2')`` as a function of the update count:
    lr(t) = base + (max - base) * max(0, 1 - x) / 2^(cycle - 1)."""

    def schedule(step: int) -> float:
        cycle = math.floor(1 + step / (2 * step_size_up))
        x = abs(step / step_size_up - 2 * cycle + 1)
        scale = 1.0 / (2.0 ** (cycle - 1))
        return base_lr + (max_lr - base_lr) * max(0.0, 1.0 - x) * scale

    return schedule


def build_optimizer(params, hparams, steps_per_epoch: int | None = None):
    """-> (optimizer, scheduler) over ``params`` from a model.hparams node
    (``lr``, ``lr_scheduler``, ``optim.{name, momentum}``). The scheduler
    sets the learning rate of every update, constant where ``lr_scheduler``
    is off; step it once per optimizer update (``update`` does)."""
    lr = float(hparams.lr)
    if hparams.lr_scheduler:
        sched = cyclic_triangular2(lr / 10, lr)
        if steps_per_epoch:
            inner, n = sched, int(steps_per_epoch)

            def sched(step):
                return inner(step // n)
    else:
        def sched(step):
            return lr

    name = hparams.optim.name
    # the optimizer's own lr is 1.0: the scheduler's factor is the lr itself
    if name == "SGD":
        opt = torch.optim.SGD(params, lr=1.0,
                              momentum=float(hparams.optim.momentum))
    elif name == "Adam":
        opt = torch.optim.Adam(params, lr=1.0)
    else:
        raise ValueError(f"Invalid optimizer: {name}")
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, sched)


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float,
                         ep_groups: Sequence | None = None) -> None:
    """optax's ``clip_by_global_norm`` in place: where the global norm is
    at least ``max_norm``, every gradient becomes g / norm * max_norm. On
    the device, without a host sync. The norm is the whole model's: under
    FSDP2 (gradients that are sharded DTensors) the squared norms of the
    local shards summed over the ranks that shard them; under ``ep`` (a
    gradient whose entry of ``ep_groups`` is a process group: an expert
    slice's) the squared norms of the slices summed over that ``ep``
    group. Where the gradients lie on several devices (the stages of
    ``pp``), each device's squared norms are summed there, the sums meet on
    the first gradient's device, and the scale goes back to each device.
    """
    from torch.distributed.tensor import DTensor
    local = [g.to_local() if isinstance(g, DTensor) else g for g in grads]
    by_device = {}
    for g in local:
        by_device.setdefault(g.device, []).append(g)
    if len(by_device) > 1:
        _clip_across_devices(list(by_device.values()), max_norm)
        return
    norms = torch.stack([torch.linalg.vector_norm(g) for g in local])
    sharded = [isinstance(g, DTensor) for g in grads]
    sliced = [g is not None for g in (ep_groups or ())]
    # (which gradients, the groups their squared norms are summed over)
    parts = []
    if any(sharded):
        g0 = grads[sharded.index(True)]
        parts.append((sharded, [g0.device_mesh.get_group(d) for d, pl in
                                enumerate(g0.placements) if pl.is_shard()]))
    if any(sliced):
        parts.append((sliced, [ep_groups[sliced.index(True)]]))
    if not parts:
        norm = torch.linalg.vector_norm(norms)
    else:
        sq = norms.square()
        whole, total = torch.ones_like(sq, dtype=torch.bool), sq.new_zeros(())
        for which, groups in parts:
            mask = torch.tensor(which, device=norms.device)
            part = torch.where(mask, sq, 0.0).sum()
            for group in groups:
                torch.distributed.all_reduce(part, group=group)
            total, whole = total + part, whole & ~mask
        norm = (torch.where(whole, sq, 0.0).sum() + total).sqrt()
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(local, scale)


def _clip_across_devices(groups: Sequence[Sequence[torch.Tensor]],
                         max_norm: float) -> None:
    """``clip_by_global_norm_`` of gradients in ``groups``, each group on
    one device, without a host sync."""
    home = groups[0][0].device
    squares = [torch.stack([torch.linalg.vector_norm(g) for g in group])
               .square().sum().to(home, non_blocking=True)
               for group in groups]
    norm = torch.stack(squares).sum().sqrt()
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    for group in groups:
        torch._foreach_mul_(list(group),
                            scale.to(group[0].device, non_blocking=True))


def update(state: TrainState, grad_batches: int = 1,
           grad_clip_val: float | None = None) -> bool:
    """Account one microbatch whose gradient (of loss / ``grad_batches``)
    is in the parameters' ``.grad``; on every ``grad_batches``-th, clip
    the accumulated mean, step the optimizer and the scheduler and clear
    the gradients. -> whether it made an update."""
    state.mini_step += 1
    if state.mini_step < grad_batches:
        return False
    if grad_clip_val:
        params = [p for group in state.optimizer.param_groups
                  for p in group["params"] if p.grad is not None]
        clip_by_global_norm_(
            [p.grad for p in params], float(grad_clip_val),
            [getattr(getattr(p, "ep_slice", None), "group", None)
             for p in params])
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    state.scheduler.step()
    state.step += 1
    state.mini_step = 0
    return True
