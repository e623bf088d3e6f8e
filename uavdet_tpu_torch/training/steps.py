"""Train and eval steps: ``uavdet_tpu/training/steps.py`` in torch.

One train step takes one microbatch: forward in train mode (under autocast
to the compute dtype), YOLO targets encoded on the device, the loss in
float32, backward of loss / k, and an optimizer update every k = grad_batches
microbatches (``optim.update``). It runs the plain modules: the stem and
dyconv kernels have no backward, as the Pallas kernels have none.

Compute dtype: the parameters stay float32 and the forward runs under
``torch.autocast`` to the compute dtype, where the JAX package builds its
modules with ``dtype=bf16`` over float32 parameters. The models cast their
input to the parameters' dtype, so without autocast a float32 model computes
in float32 whatever the frames' dtype.

The head strides come from the feature maps' widths (``input_size // W``),
not from ``head_scales`` (nor from their rows, a band's under ``sp``).

On a mesh (``mesh``, with ``model`` placed by ``parallel.shard_model``)
each rank's batch is its own rows. The loss is a per-sample mean, then a
batch mean, and DDP and FSDP2 average the ranks' gradients, which is the
global batch's gradient only where every rank holds as many rows; so each
rank's loss is scaled by ``rows * world / global rows`` (1.0 where the
rows are equal), and a short batch (``drop_last`` false, a drop-empty) still
gives the global mean. One all-reduce per microbatch carries the rows and
the row-weighted losses, so the metrics are the global batch's on every
rank. With ``grad_batches`` above 1 the gradients stay on the rank for all
but the last microbatch of an update (``parallel.gradient_sync``).

Under ``sp`` a rank's batch is its rows' whole frames; the step keeps its
band of their rows (``parallel.row_band``), encodes the targets on the
whole grid and keeps the band's rows of them, and the loss sums its masked
means over the ``sp`` group. Every rank of an sp group then holds the
same loss, the rows count once per rank in ``_global_metrics``, and the
same scale ``rows * world / global rows`` (global rows counted over every
rank, so ``n_sp`` times the batch) makes the world's average gradient the
one-process gradient. Under ``ep`` the expert slices' gradients are
summed over the ranks that hold the same slice after an update's last
backward (``parallel.reduce_expert_grads``).
"""

import contextlib

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops.losses import LossBreakdown, yolo_loss
from ..ops.targets import encode_yolo_targets
from ..parallel import (batch_group, coordinate, gradient_sync,
                        reduce_expert_grads, row_band, sp_group, sp_rows,
                        unwrap)
from ..parallel.spatial import model_stride
from ..utils.datatypes import BatchData, TrainState
from .optim import update

# jax.checkpoint_policies names with a counterpart here
REMAT_POLICIES = (True, "dots_saveable")


def init_state(model: nn.Module, optimizer, scheduler) -> TrainState:
    """The train state of a model whose parameters are initialized, with the
    optimizer and scheduler of ``build_optimizer`` over them."""
    return TrainState(model=model, optimizer=optimizer, scheduler=scheduler)


def _loss_weights(hparams) -> dict:
    lb = hparams.loss_balancing
    get = (hparams.get if hasattr(hparams, "get")
           else lambda k, d: getattr(hparams, k, d))
    return dict(
        obj_scales_w=tuple(float(w) for w in lb.obj_scales_w),
        bbox_w=float(lb.bbox_w),
        objectness_w=float(lb.objectness_w),
        no_obj_w=float(lb.no_obj_w),
        bbox_loss_fn=str(hparams.bbox_loss_fn),
        iou_mode=str(get("iou_mode", "elementwise")))


def autocast(device: torch.device, compute_dtype: torch.dtype):
    """The forward's autocast context: to ``compute_dtype`` where it is
    lower than float32, none otherwise."""
    if compute_dtype in (torch.float32, torch.float64):
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=compute_dtype)


def _anchors(hparams, device) -> torch.Tensor:
    """The anchors (H, A, 2) in pixels on the model's device, made once per
    step function: a copy from pageable host memory at every step would make
    the host wait there for the card to catch up."""
    return torch.tensor(np.asarray(hparams.anchors, np.float32),
                        device=device)


class _Band:
    """A rank's band of rows under ``sp`` (None where sp has one rank)."""

    def __init__(self, model, mesh, input_size: int):
        self.group = sp_group(mesh)
        if self.group is None:
            return
        self.index = coordinate(mesh)[2]
        self.n = mesh["sp"].size()
        self.rows = row_band(self.index, self.n, input_size,
                             model_stride(unwrap(model)))

    def image(self, x):
        if self.group is None:
            return x
        return x[:, self.rows.start:self.rows.stop]


def _loss(outs, batch: BatchData, anchors, input_size: int, weights: dict,
          band=None):
    scales = tuple(input_size // o.obj.shape[3] for o in outs)
    grids = encode_yolo_targets(batch.boxes, batch.box_mask, anchors, scales,
                                input_size)
    if band is None or band.group is None:
        return yolo_loss(outs, grids, anchors, scales, **weights)
    offsets = [band.index * o.obj.shape[2] for o in outs]
    grids = [g[:, :, r:r + o.obj.shape[2]]
             for g, r, o in zip(grids, offsets, outs)]
    return yolo_loss(outs, grids, anchors, scales, **weights,
                     sp_group=band.group, row_offsets=offsets)


def _global_metrics(lb, rows: int, group) -> tuple:
    """-> (metrics of the global batch, this rank's loss scale ``rows *
    world / global rows``): one all-reduce of the rows and the row-weighted
    losses over ``group``. A rank without rows adds zeros."""
    losses = torch.stack([lb.total, lb.bbox, lb.obj]).detach().float()
    packed = torch.cat([losses.new_full((1,), float(rows)),
                        losses * rows if rows else torch.zeros_like(losses)])
    dist.all_reduce(packed, group=group)
    total = packed[0]
    means = packed[1:] / total
    metrics = {"loss": means[0], "bbox_loss": means[1],
               "obj_loss": means[2]}
    return metrics, rows * dist.get_world_size(group) / total


def _saves_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``jax.checkpoint_policies
    .dots_saveable``: keep the outputs of convolutions and matmuls,
    recompute the rest."""
    aten = torch.ops.aten
    dots = (aten.convolution.default, aten.mm.default, aten.bmm.default,
            aten.addmm.default)
    return (CheckpointPolicy.MUST_SAVE if op in dots
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _bn_buffers(model: nn.Module):
    return [b for name, b in model.named_buffers()
            if name.endswith(("running_mean", "running_var",
                              "num_batches_tracked"))]


def make_train_step(model: nn.Module, hparams, input_size: int,
                    compute_dtype: torch.dtype = torch.float32,
                    grad_batches: int = 1,
                    grad_clip_val: float | None = None, remat=False,
                    nan_guard: bool = False, mesh=None):
    """-> ``train_step(state, batch) -> metrics``: one microbatch, the
    update every ``grad_batches``-th; metrics ``loss``, ``bbox_loss`` and
    ``obj_loss`` as device tensors. On a ``mesh`` ``model`` is the placed
    model, ``batch`` the rank's rows (see the module docstring), and the
    metrics those of the global batch.

    ``remat``: recompute the forward in the backward
    (``torch.utils.checkpoint``): ``True`` keeps nothing, ``'dots_saveable'``
    keeps the outputs of convs and matmuls. The recomputation runs the
    BatchNorms in train mode again; their buffers are put back to what the
    forward left. Any other value but False raises.

    ``nan_guard``: the step fetches the loss before its backward, and on a
    non-finite loss puts the BatchNorm buffers back to what they were
    before the step and returns the metrics without a backward or an
    update: the accumulated gradients of earlier microbatches stay, as in
    ``optax.MultiSteps`` when the JAX trainer discards the poisoned state.
    """
    if remat not in (False, *REMAT_POLICIES):
        raise ValueError(f"remat={remat!r} has no counterpart in the torch "
                         f"port; it takes False, True or 'dots_saveable'")
    device = next(model.parameters()).device
    anchors = _anchors(hparams, device)
    weights = _loss_weights(hparams)

    def forward(x):
        with autocast(device, compute_dtype):
            return model(x)

    if remat:
        plain_forward = forward
        kw = ({} if remat is True else dict(
            context_fn=lambda: create_selective_checkpoint_contexts(
                _saves_dots)))

        def forward(x):
            return checkpoint(plain_forward, x, use_reentrant=False, **kw)

    buffers = _bn_buffers(model)
    group = batch_group(mesh)
    band = _Band(model, mesh, input_size)
    ep = mesh is not None and mesh["ep"].size() > 1

    def train_step(state: TrainState, batch: BatchData) -> dict:
        model.train()
        before = ([b.clone() for b in buffers] if nan_guard else None)
        sync = state.mini_step + 1 >= grad_batches
        with gradient_sync(model, sync):
            outs = forward(band.image(batch.image))
            lb = _loss(outs, batch, anchors, input_size, weights, band)
            loss = lb.total
            if group is None:
                metrics = {"loss": lb.total.detach(),
                           "bbox_loss": lb.bbox.detach(),
                           "obj_loss": lb.obj.detach()}
            else:
                metrics, scale = _global_metrics(lb, len(batch.image), group)
                loss = loss * scale
            if nan_guard and not bool(torch.isfinite(metrics["loss"])):
                torch._foreach_copy_(buffers, before)
                return metrics
            after = [b.clone() for b in buffers] if remat else None
            (loss / grad_batches).backward()
        if ep and sync:
            reduce_expert_grads(unwrap(model), mesh)
        if remat:
            torch._foreach_copy_(buffers, after)
        update(state, grad_batches, grad_clip_val)
        return metrics

    return train_step


def make_eval_step(model: nn.Module, hparams, input_size: int,
                   compute_dtype: torch.dtype = torch.float32, mesh=None):
    """-> ``eval_step(batch) -> metrics`` (the validation loss), the
    forward in eval mode; metrics as device tensors. On a ``mesh`` the
    batch is the rank's rows and the metrics those of the global batch,
    weighted by rows; under ``sp`` the model runs on the rank's band of
    their rows, as the train step."""
    device = next(model.parameters()).device
    anchors = _anchors(hparams, device)
    weights = _loss_weights(hparams)
    group = batch_group(mesh)
    band = _Band(model, mesh, input_size)

    @torch.no_grad()
    def eval_step(batch: BatchData) -> dict:
        model.eval()
        rows = len(batch.image)
        if group is not None and rows == 0:   # nothing to run, one to sum
            lb = LossBreakdown(*torch.zeros(3, device=device))
        else:
            with autocast(device, compute_dtype), sp_rows(model, band.group):
                outs = model(band.image(batch.image))
            lb = _loss(outs, batch, anchors, input_size, weights, band)
        if group is not None:
            return _global_metrics(lb, rows, group)[0]
        return {"loss": lb.total, "bbox_loss": lb.bbox, "obj_loss": lb.obj}

    return eval_step
