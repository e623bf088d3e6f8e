"""Containers of the port: NamedTuples of tensors, and the train state.

The same contracts as ``uavdet_tpu/utils/datatypes.py`` and
``uavdet_tpu/inference.py:Detections``, without JAX. ``TrainState`` holds
what torch keeps as objects that change in place (the module, the optimizer,
the scheduler) instead of a pytree that a jitted step returns anew.
"""

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch


class DetectionResults(NamedTuple):
    """Raw per-head predictions.

    bbox: (B, A, H, W, 4) box logits; obj: (B, A, H, W, 1) objectness logits.
    """

    bbox: torch.Tensor
    obj: torch.Tensor


class Detections(NamedTuple):
    """Fixed-shape detection results; invalid slots have score 0 and box 0."""

    boxes: torch.Tensor   # (B, max_det, 4) xyxy pixels
    scores: torch.Tensor  # (B, max_det)
    valid: torch.Tensor   # (B, max_det) bool


class BatchData(NamedTuple):
    """One training batch.

    image:    (B, H, W, C) float in [0, 1], NHWC.
    boxes:    (B, N, 4) float, xyxy in normalized [0, 1] image coordinates.
    box_mask: (B, N) bool, True for real boxes, False for padding.
    """

    image: torch.Tensor
    boxes: torch.Tensor
    box_mask: torch.Tensor


class Targets(NamedTuple):
    """Dense per-head YOLO grid targets, one (B, A, S, S, 5) entry per head,
    [obj, off_cx, off_cy, grid_w, grid_h] in the last axis."""

    grids: Tuple[torch.Tensor, ...]


@dataclass
class TrainState:
    """The model, its optimizer and learning-rate scheduler, and where
    training stands: ``step`` optimizer updates made, ``mini_step``
    microbatches whose gradients are accumulated toward the next one (the
    ``mini_step`` of ``optax.MultiSteps``)."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0
    mini_step: int = 0
