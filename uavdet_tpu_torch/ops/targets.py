"""YOLO target encoding on the device: ``uavdet_tpu/ops/targets.py`` in
torch.

For each box and each detection head:
  * the box center picks one grid cell; the offsets are the fractional
    parts, width and height are in grid units (``w * S``);
  * anchors are assigned by w/h-only IoU: if the best IoU is below 0.5 only
    the best anchor is written (obj = 1), otherwise every anchor gets the
    coordinates and obj = 1 where its IoU is at least 0.5.

Padding boxes (mask False) write nothing. Boxes are written one after the
other, so a later box overwrites an earlier one in the same cell, as the
reference's loop does: the loop runs over the padded box axis and each
iteration writes one cell per image, so no write has a duplicate index
(whose winner a scatter on CUDA leaves undefined).
"""

from typing import Sequence, Tuple

import numpy as np
import torch

from .boxes import anchor_iou, box_convert


def head_sizes(input_size: int,
               head_scales: Sequence[int]) -> Tuple[int, ...]:
    """Grid size per head: ``input_size // scale``."""
    return tuple(input_size // s for s in head_scales)


def _encode_one_head(boxes_cxcywh: torch.Tensor, mask: torch.Tensor,
                     anchors: torch.Tensor, size: int) -> torch.Tensor:
    """boxes_cxcywh (B, N, 4) normalized, mask (B, N), anchors (A, 2)
    normalized -> (B, A, size, size, 5)."""
    b, n = mask.shape
    n_anchors = anchors.shape[0]
    grid = torch.zeros((b, n_anchors, size, size, 5),
                       dtype=boxes_cxcywh.dtype, device=boxes_cxcywh.device)
    rows = torch.arange(b, device=grid.device)
    arange_a = torch.arange(n_anchors, device=grid.device)
    for i in range(n):
        cx, cy, w, h = boxes_cxcywh[:, i].unbind(-1)            # (B,) each
        gcx, gcy = cx * size, cy * size
        # int conversion truncates toward zero, then the clip
        gx = gcx.to(torch.int32).clamp(0, size - 1)
        gy = gcy.to(torch.int32).clamp(0, size - 1)
        coords = torch.stack([gcx - gx, gcy - gy, w * size, h * size], -1)
        ious = anchor_iou(torch.stack([w, h], -1), anchors)     # (B, A)
        best = torch.argmax(ious, dim=-1, keepdim=True)          # (B, 1)
        best_iou = torch.gather(ious, 1, best)
        is_best = arange_a[None] == best
        write = ((best_iou >= 0.5) | is_best) & mask[:, i, None]
        obj = torch.where(ious >= 0.5, 1.0, torch.where(
            is_best & (best_iou < 0.5), 1.0, 0.0)).to(grid.dtype)
        vals = torch.cat([obj[..., None],
                          coords[:, None].expand(b, n_anchors, 4)], dim=-1)
        gx, gy = gx.long(), gy.long()
        old = grid[rows, :, gy, gx]                              # (B, A, 5)
        grid[rows, :, gy, gx] = torch.where(write[..., None], vals, old)
    return grid


def validate_targets(grids, head_sizes_: Sequence[int]) -> None:
    """Host-side sanity net over encoded grids (the reference's inline
    assertion test): head count, objectness in [0, 1], no NaN or Inf. For
    debug paths; it copies every grid to the host."""
    if len(grids) != len(head_sizes_):
        raise ValueError("Number of scaled targets not match with detection "
                         "heads")
    for i, g in enumerate(grids):
        a = g.detach().cpu().double().numpy() if torch.is_tensor(g) \
            else np.asarray(g)
        obj = a[..., 0]
        if not ((obj >= 0) & (obj <= 1)).all():
            raise ValueError(f"Scale bbox {i} has invalid objectness values")
        if np.isnan(a).any():
            raise ValueError(f"Scale bbox {i} contains NaN values")
        if np.isinf(a).any():
            raise ValueError(f"Scale bbox {i} contains Inf values")


def encode_yolo_targets(boxes_xyxy: torch.Tensor, box_mask: torch.Tensor,
                        anchors, head_scales: Sequence[int],
                        input_size: int) -> Tuple[torch.Tensor, ...]:
    """Encode a batch of normalized xyxy boxes into per-head dense grids.

    boxes_xyxy: (B, N, 4) normalized [0, 1] xyxy; box_mask: (B, N) bool;
    anchors: (H, A, 2) anchor priors in pixels (array, nested sequence or
    tensor; a tensor already on the boxes' device is not copied), normalized
    here by ``input_size``. -> H tensors (B, A, S_h, S_h, 5) on the boxes' device,
    in the boxes' dtype floored at float32.
    """
    dtype = torch.promote_types(boxes_xyxy.dtype, torch.float32)
    device = boxes_xyxy.device
    anchors = torch.as_tensor(anchors, device=device).to(dtype) / input_size
    boxes_cxcywh = box_convert(boxes_xyxy.to(dtype), "xyxy", "cxcywh")
    mask = box_mask.to(device=device, dtype=torch.bool)
    return tuple(_encode_one_head(boxes_cxcywh, mask, anchors[h], size)
                 for h, size in enumerate(head_sizes(input_size,
                                                     head_scales)))
