"""Pipeline parallelism (``pp``): ``uavdet_tpu/parallel/pipeline.py`` in
torch.

The ``layer_config`` token list is cut into S contiguous, cost-balanced
stages (``split_tokens``, the JAX function operation for operation). A
``PipelineStage`` is a slice of an existing interpreter model's ``layers``
(its own submodules, not copies, so every state_dict key stays the
reference's ``layers.{i}...`` / ``yolo_head...``) that runs on the carry
``(x, routes, taps)``: the route stack and the heads' taps cross stage
boundaries, and the last stage applies the ``yolo_head``. A
``PipelinedModel`` places stage i's modules on ``devices[i]`` (the head with
the last one), and the carry moves to the next stage's device with
``.to(device, non_blocking=True)``.

One process drives the S stage devices, as the JAX package's one program
drives its ('pp',) mesh. The schedule is the JAX one, T = M + S - 1 ticks
(``make_pp_loss``): at tick t each stage s runs microbatch t - s where that
is one of the M, the last stage computes the loss of microbatch t - (S - 1)
on targets encoded for it on its device, and the loss is the mean over the
M microbatches. Every stage's work is launched before anything is waited
on, so where the stage devices differ their work overlaps by launch order
alone (per-stage streams are not used). The backward is autograd through
the same graph: its copies between devices are the reverse schedule, as
``jax.grad`` through ``ppermute`` is in the JAX package.

Semantics, exactly the JAX package's: one pipelined step over M
microbatches is the sequential microbatch-accumulation step. Each stage
sees the microbatches in order, so BatchNorm takes per-microbatch batch
statistics and updates its running statistics M times; the gradient is
d(mean loss)/dθ.

Not ported, because they have no counterpart here: ``_Packer``,
``pack_params`` / ``unpack_params``, ``pp_shardings``,
``pp_state_shardings`` and ``make_pp_mesh``. They keep ``ppermute``'s
operand one static shape and place one stage's parameters per device as a
``P('pp', None)`` row, which are XLA's needs. Here a stage's parameters,
BatchNorm buffers and optimizer state are simply its modules' tensors on
its device, and the optimizer runs over ``model.parameters()`` in the whole
model's order, so a pp checkpoint has the single-device keys and optimizer
indices and each restores into the other (the JAX pp checkpoint is the
packed form).

Only the interpreter models (DyYOLO, BaselineModel) have a
``layer_config``; any other model raises ``ValueError``.
"""

import copy
import functools
from typing import List, Sequence, Tuple

import torch
from torch import nn

from ..utils.datatypes import BatchData

# the models import this package (models/layers.py), so this module imports
# them where they are used


# ---------------------------------------------------------------------------
# Stage splitting (a copy of the JAX package's, which is plain Python)

def _token_cost(tok) -> float:
    """Rough per-token FLOP weight for balancing stages."""
    if tok[0] == "B":
        return 2.0 * tok[1]
    if tok[0] == "S":
        return 3.0
    if tok[0] == "U":
        return 0.5
    if tok[0] == "DyConv":
        return 1.5
    return 1.0


def split_tokens(layer_config: Sequence,
                 n_stages: int) -> List[Tuple[int, int]]:
    """Partition the token list into ``n_stages`` contiguous, non-empty,
    cost-balanced ranges [(start, end), ...]."""
    n = len(layer_config)
    if not 1 <= n_stages <= n:
        raise ValueError(f"n_stages={n_stages} must be in [1, {n}]")
    costs = [_token_cost(t) for t in layer_config]
    total = sum(costs)
    ranges, start, acc, spent = [], 0, 0.0, 0.0
    for i, c in enumerate(costs):
        acc += c
        remaining_stages = n_stages - len(ranges)
        remaining_tokens = n - i - 1
        target = (total - spent) / remaining_stages
        # close the stage when its cost reaches the fair share, or when
        # every remaining stage needs exactly one of the remaining tokens
        # (keeps all stages non-empty by construction)
        if remaining_stages > 1 and remaining_tokens >= remaining_stages - 1 \
                and (acc >= target
                     or remaining_tokens == remaining_stages - 1):
            ranges.append((start, i + 1))
            start, spent, acc = i + 1, spent + acc, 0.0
    ranges.append((start, n))
    assert len(ranges) == n_stages
    return ranges


def stage_devices(device, n_stages: int) -> List[torch.device]:
    """The stage devices the caller asks for: a list of ``n_stages``
    devices as given (two stages may share a device); a CUDA device
    ``cuda:0`` to ``cuda:{S-1}``, raising where fewer are visible; any
    other device ``n_stages`` times."""
    if isinstance(device, (list, tuple)):
        if len(device) != n_stages:
            raise ValueError(f"{len(device)} stage devices for "
                             f"pp_devices={n_stages}")
        return [torch.device(d) for d in device]
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * n_stages
    visible = torch.cuda.device_count()
    if visible < n_stages:
        raise ValueError(f"pp_devices={n_stages} but only {visible} CUDA "
                         "device(s) visible")
    return [torch.device("cuda", i) for i in range(n_stages)]


# ---------------------------------------------------------------------------
# Stages

class PipelineStage(nn.Module):
    """Tokens ``start:end`` of ``model`` (a ``YOLOInterpreter``) on the
    carry ``(x, routes, taps)``. Its submodules are the model's own, under
    the model's names (``layers.{i}``, ``yolo_head`` on the last stage), so
    its state_dict keys are the model's. The first stage takes the NHWC
    frames and works on their NCHW view, as ``YOLOInterpreter.forward``."""

    def __init__(self, model: nn.Module, start: int, end: int,
                 is_last: bool):
        super().__init__()
        self.tokens = model.tokens[start:end]
        self.first_layer = model.first_layer[start:end]
        stop = (model.first_layer[end] if end < len(model.tokens)
                else len(model.layers))
        self.layers = nn.ModuleDict({str(i): model.layers[i] for i in
                                     range(self.first_layer[0], stop)})
        self._by_index = {int(k): m for k, m in self.layers.items()}
        self.yolo_head = model.yolo_head if is_last else None
        self.is_first = start == 0
        self.attn_temperature = model.attn_temperature

    def forward(self, x: torch.Tensor, routes=(), taps=()):
        """-> the carry ``(x, routes, taps)`` for the next stage, or on the
        last stage one DetectionResults per head."""
        from ..models.interpreter import run_tokens
        if self.is_first:
            x = x.to(next(self.parameters()).dtype).permute(0, 3, 1, 2)
        routes, taps = list(routes), list(taps)
        x = run_tokens(self._by_index, self.tokens, self.first_layer, x,
                       routes, taps, self.attn_temperature)
        if self.yolo_head is not None:
            return self.yolo_head(taps)
        return x, routes, taps


def _moved(carry, device: torch.device):
    x, routes, taps = carry
    return (x.to(device, non_blocking=True),
            [r.to(device, non_blocking=True) for r in routes],
            [t.to(device, non_blocking=True) for t in taps])


class PipelinedModel:
    """The S stages of ``model`` (an interpreter model, DyYOLO or
    BaselineModel), stage i's modules moved to ``devices[i]`` in place."""

    def __init__(self, model: nn.Module, n_stages: int,
                 devices: Sequence):
        from ..models.interpreter import YOLOInterpreter
        if not isinstance(model, YOLOInterpreter):
            raise ValueError(
                f"{type(model).__name__} has no layer_config: pipeline "
                "stages split the interpreter models (DyYOLO, "
                "BaselineModel) only")
        self.devices = [torch.device(d) for d in devices]
        if len(self.devices) != n_stages:
            raise ValueError(f"{len(self.devices)} devices for {n_stages} "
                             "stages")
        self.model = model
        self.n_stages = n_stages
        self.ranges = split_tokens(model.tokens, n_stages)
        self.stages = [PipelineStage(model, s, e, i == n_stages - 1)
                       for i, (s, e) in enumerate(self.ranges)]
        for stage, device in zip(self.stages, self.devices):
            stage.to(device)

    @classmethod
    def from_hparams(cls, hparams, n_stages: int, devices: Sequence,
                     seed: int = 0) -> "PipelinedModel":
        """A float32 DyYOLO of a model hparams block (``layer_config``,
        ``anchors``, ``attn_temperature``) with the seeded weights of
        ``utils.seeding.init_weights``, split into ``n_stages``."""
        from ..models.dy_yolo import DyYOLO
        from ..utils.seeding import init_weights
        get = (hparams.get if hasattr(hparams, "get")
               else lambda k, d: getattr(hparams, k, d))
        model = DyYOLO(hparams.layer_config,
                       n_anchors=len(hparams.anchors[0]),
                       attn_temperature=float(get("attn_temperature", 30.0)))
        return cls(init_weights(model, seed), n_stages, devices)

    def stage_keys(self) -> List[List[str]]:
        """Each stage's state_dict keys (the model's names)."""
        return [list(stage.state_dict()) for stage in self.stages]

    @functools.cached_property
    def eval_model(self) -> nn.Module:
        """A plain copy of the model on the first stage's device, made at
        the first use with the weights of then; ``parallel.
        copy_full_weights(pm.model, pm.eval_model)`` refreshes it."""
        return copy.deepcopy(self.model).to(self.devices[0])

    def sequential_apply(self, image: torch.Tensor, train: bool = False):
        """One microbatch through the stages in order: what one wave of
        the schedule computes. -> one DetectionResults per head."""
        self.model.train(train)
        carry = (image.to(self.devices[0], non_blocking=True), (), ())
        for i, stage in enumerate(self.stages):
            out = stage(*carry)
            if i + 1 < self.n_stages:
                carry = _moved(out, self.devices[i + 1])
        return out


# ---------------------------------------------------------------------------
# The pipelined step

def make_pp_loss(pm: PipelinedModel, hparams, input_size: int,
                 n_micro: int, compute_dtype: torch.dtype = torch.float32):
    """-> ``loss_fn(images, boxes, mask) -> (loss, metrics)``: images (M,
    mb, H, W, 3), boxes (M, mb, N, 4), mask (M, mb, N) on any device; the
    loss is the mean of the M microbatches' losses (differentiable), the
    metrics ``loss``, ``bbox_loss``, ``obj_loss`` (means over M) and
    ``microbatch_loss`` (M,), detached. The stages run in train or eval mode
    as the model is; the forward under autocast to ``compute_dtype``, the
    loss in float32, as ``training.make_train_step``."""
    from ..training.steps import _anchors, _loss, _loss_weights, autocast

    S, M = pm.n_stages, n_micro
    last = pm.devices[-1]
    anchors = _anchors(hparams, last)
    weights = _loss_weights(hparams)

    def loss_fn(images, boxes, mask):
        if len(images) != M:
            raise ValueError(f"{len(images)} microbatches, expected {M}")
        boxes = boxes.to(last, non_blocking=True)
        mask = mask.to(last, non_blocking=True)
        inbox = [None] * S   # the carry waiting for each stage
        parts = []
        for t in range(M + S - 1):
            # the later stages first: each takes its carry before the stage
            # behind it hands over the next one
            for s in reversed(range(S)):
                m = t - s
                if not 0 <= m < M:
                    continue
                carry = ((images[m].to(pm.devices[0], non_blocking=True),
                          (), ()) if s == 0 else inbox[s])
                with autocast(pm.devices[s], compute_dtype):
                    out = pm.stages[s](*carry)
                if s < S - 1:
                    inbox[s + 1] = _moved(out, pm.devices[s + 1])
                else:
                    parts.append(_loss(out, BatchData(None, boxes[m],
                                                      mask[m]),
                                       anchors, input_size, weights))
        totals = torch.stack([lb.total for lb in parts])
        loss = totals.mean()
        metrics = {
            "loss": loss.detach(),
            "bbox_loss": torch.stack([lb.bbox for lb in parts]).mean()
            .detach(),
            "obj_loss": torch.stack([lb.obj for lb in parts]).mean().detach(),
            "microbatch_loss": totals.detach()}
        return loss, metrics

    return loss_fn


def make_pp_train_step(pm: PipelinedModel, hparams, input_size: int,
                       n_micro: int,
                       compute_dtype: torch.dtype = torch.float32,
                       grad_batches: int = 1,
                       grad_clip_val: float | None = None,
                       nan_guard: bool = False):
    """-> ``step(state, images, boxes, mask) -> metrics`` over M =
    ``n_micro`` microbatches (``make_pp_loss``'s shapes): the model in train
    mode, one backward of the mean loss / ``grad_batches``, then
    ``training.optim.update``: an optimizer update every ``grad_batches``
    steps with global-norm clipping at ``grad_clip_val``, as ``optax.
    MultiSteps`` and ``clip_by_global_norm`` in the JAX ``tx``. ``state``
    is a ``TrainState`` over ``pm.model``.

    ``nan_guard``: as ``training.make_train_step``'s, the loss is fetched
    before the backward; a non-finite one puts the BatchNorm buffers back
    to what they were before the step and returns the metrics without a
    backward or an update. There is no ``remat``: the JAX pp step takes
    none either."""
    from ..training.optim import update
    from ..training.steps import _bn_buffers

    loss_fn = make_pp_loss(pm, hparams, input_size, n_micro, compute_dtype)
    buffers = _bn_buffers(pm.model)

    def step(state, images, boxes, mask) -> dict:
        pm.model.train()
        before = [b.clone() for b in buffers] if nan_guard else None
        loss, metrics = loss_fn(images, boxes, mask)
        if nan_guard and not bool(torch.isfinite(metrics["loss"])):
            torch._foreach_copy_(buffers, before)
            return metrics
        (loss / grad_batches).backward()
        update(state, grad_batches, grad_clip_val)
        return metrics

    return step


def make_pp_trainer_step(pm: PipelinedModel, hparams, input_size: int,
                         n_micro: int,
                         compute_dtype: torch.dtype = torch.float32,
                         grad_batches: int = 1,
                         grad_clip_val: float | None = None,
                         nan_guard: bool = False):
    """The Trainer-shaped step, ``step(state, batch) -> metrics``: the
    batch's rows cut into ``n_micro`` microbatches of equal size, then
    ``make_pp_train_step``'s step."""
    step = make_pp_train_step(pm, hparams, input_size, n_micro,
                              compute_dtype, grad_batches, grad_clip_val,
                              nan_guard)

    def trainer_step(state, batch: BatchData) -> dict:
        rows = len(batch.image)
        if rows % n_micro:
            raise ValueError(f"a batch of {rows} rows does not split into "
                             f"pp_microbatches={n_micro}")
        return step(state, *(t.reshape(n_micro, rows // n_micro,
                                       *t.shape[1:]) for t in batch))

    return trainer_step


def make_pp_eval_step(pm: PipelinedModel, hparams, input_size: int,
                      compute_dtype: torch.dtype = torch.float32):
    """The validation loss: ``training.make_eval_step`` on
    ``pm.eval_model``, the plain copy of the model on the first stage's
    device (refresh it after updates; see ``PipelinedModel.eval_model``),
    as the JAX pp eval step runs the standard one on the merged stages."""
    from ..training.steps import make_eval_step
    return make_eval_step(pm.eval_model, hparams, input_size, compute_dtype)
