"""Box geometry: ``uavdet_tpu/ops/boxes.py`` in torch.

The operations and their order are the reference's, so that the IoU that NMS
uses, and hence every suppression decision, is bitwise the same, and the
loss terms round as the reference's do. Leading dims are any; the last is 4.
"""

import math

import torch

_EPS = 1e-7


def box_convert(boxes: torch.Tensor, in_fmt: str,
                out_fmt: str) -> torch.Tensor:
    """Convert between 'xyxy', 'xywh' (top-left + size) and 'cxcywh'."""
    if in_fmt == out_fmt:
        return boxes
    a, b, c, d = boxes.unbind(-1)
    if in_fmt == "xyxy":
        x1, y1, x2, y2 = a, b, c, d
    elif in_fmt == "xywh":
        x1, y1, x2, y2 = a, b, a + c, b + d
    elif in_fmt == "cxcywh":
        x1, y1, x2, y2 = a - c / 2, b - d / 2, a + c / 2, b + d / 2
    else:
        raise ValueError(f"unknown in_fmt {in_fmt}")
    if out_fmt == "xyxy":
        out = (x1, y1, x2, y2)
    elif out_fmt == "xywh":
        out = (x1, y1, x2 - x1, y2 - y1)
    elif out_fmt == "cxcywh":
        out = ((x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1)
    else:
        raise ValueError(f"unknown out_fmt {out_fmt}")
    return torch.stack(out, dim=-1)


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


def box_iou_elementwise(boxes1: torch.Tensor,
                        boxes2: torch.Tensor) -> torch.Tensor:
    """Elementwise IoU of xyxy boxes over matching leading dims."""
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = torch.clamp_min(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(boxes1) + box_area(boxes2) - inter
    return inter / torch.clamp_min(union, _EPS)


def complete_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor,
                     eps: float = 1e-7) -> torch.Tensor:
    """Elementwise Complete IoU of xyxy boxes: IoU - rho2/c2 - alpha*v
    (torchvision's ``complete_box_iou_loss`` terms), ``alpha`` detached."""
    iou = box_iou_elementwise(boxes1, boxes2)
    # smallest enclosing box diagonal
    lt = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    whc = rb - lt
    c2 = whc[..., 0] ** 2 + whc[..., 1] ** 2 + eps
    # center distance
    c1 = (boxes1[..., :2] + boxes1[..., 2:]) / 2
    c2_ = (boxes2[..., :2] + boxes2[..., 2:]) / 2
    rho2 = torch.sum((c1 - c2_) ** 2, dim=-1)
    # aspect-ratio consistency
    w1 = boxes1[..., 2] - boxes1[..., 0]
    h1 = boxes1[..., 3] - boxes1[..., 1]
    w2 = boxes2[..., 2] - boxes2[..., 0]
    h2 = boxes2[..., 3] - boxes2[..., 1]
    v = (4 / (math.pi ** 2)) * (
        torch.arctan(w2 / torch.clamp_min(h2, eps))
        - torch.arctan(w1 / torch.clamp_min(h1, eps))) ** 2
    alpha = (v / torch.clamp_min(1 - iou + v, eps)).detach()
    return iou - rho2 / c2 - alpha * v


def anchor_iou(target_wh: torch.Tensor,
               anchors_wh: torch.Tensor) -> torch.Tensor:
    """Width/height-only IoU of co-centered boxes: target_wh (..., 2) and
    anchors (A, 2) -> (..., A); intersection min(w) * min(h)."""
    tw, th = target_wh[..., None, 0], target_wh[..., None, 1]
    aw, ah = anchors_wh[..., 0], anchors_wh[..., 1]
    inter = torch.minimum(aw, tw) * torch.minimum(ah, th)
    union = aw * ah + tw * th - inter
    return inter / torch.clamp_min(union, _EPS)
