"""Box geometry that NMS needs: ``uavdet_tpu/ops/boxes.py:45-57`` in torch.

The operations and their order are the reference's, so that the IoU, and
hence every suppression decision, is bitwise the same.
"""

import torch

_EPS = 1e-7


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (torch.clamp_min(boxes[..., 2] - boxes[..., 0], 0)
            * torch.clamp_min(boxes[..., 3] - boxes[..., 1], 0))


def box_iou_pairwise(boxes1: torch.Tensor,
                     boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU (..., N, M) of xyxy boxes (..., N, 4) and (..., M, 4)."""
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = torch.clamp_min(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    union = (box_area(boxes1)[..., :, None] + box_area(boxes2)[..., None, :]
             - inter)
    return inter / torch.clamp_min(union, _EPS)
