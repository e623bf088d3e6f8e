"""Result containers of the port, as NamedTuples of tensors.

The same contracts as ``uavdet_tpu/utils/datatypes.py`` and
``uavdet_tpu/inference.py:Detections``, without JAX.
"""

from typing import NamedTuple

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
