"""Prediction decoding for the loss: ``uavdet_tpu/ops/decode.py`` in torch.

YOLOv4/v5 parametrization (reference ``YOLOHead.__pred_bbox_decoding``):
    cx = sigmoid(t) * 2 - 0.5          (grid-cell offset)
    w  = (sigmoid(t) * 2) ** 2         (anchor-relative size)
and, in 'ciou' mode only, the absolute grid coordinates are added and the
sizes multiplied by the head's anchors.
"""

import torch


def _grid(h: int, w: int, like: torch.Tensor, row_offset: int = 0):
    """(H, W) column and row indices in ``like``'s dtype and device; the
    rows counted from ``row_offset`` (a band of a larger grid)."""
    gx = torch.arange(w, dtype=like.dtype, device=like.device)
    gy = torch.arange(row_offset, row_offset + h, dtype=like.dtype,
                      device=like.device)
    return gx[None, :].expand(h, w), gy[:, None].expand(h, w)


def decode_predictions(pred_bbox: torch.Tensor, scaled_anchors: torch.Tensor,
                       bbox_loss_fn: str = "mse",
                       row_offset: int = 0) -> torch.Tensor:
    """pred_bbox (..., A, H, W, 4) logits; scaled_anchors (A, 2) in grid
    units -> (..., A, H, W, 4) cxcywh in grid units ('ciou') or
    cell-relative offsets and anchor-relative sizes ('mse'). ``row_offset``:
    the grid row of the first row (a band of rows under ``sp``)."""
    s = torch.sigmoid(pred_bbox)
    pcx = s[..., 0] * 2.0 - 0.5
    pcy = s[..., 1] * 2.0 - 0.5
    pw = (s[..., 2] * 2.0) ** 2
    ph = (s[..., 3] * 2.0) ** 2
    if bbox_loss_fn == "ciou":
        grid_x, grid_y = _grid(pred_bbox.shape[-3], pred_bbox.shape[-2],
                               pred_bbox, row_offset)
        pcx = pcx + grid_x
        pcy = pcy + grid_y
        pw = pw * scaled_anchors[:, 0][..., :, None, None]
        ph = ph * scaled_anchors[:, 1][..., :, None, None]
    return torch.stack([pcx, pcy, pw, ph], dim=-1)


def add_grid_offsets(t_bbox: torch.Tensor,
                     row_offset: int = 0) -> torch.Tensor:
    """'ciou'-mode target: the absolute grid coordinates added to the
    cell-relative cx, cy (rows from ``row_offset``)."""
    grid_x, grid_y = _grid(t_bbox.shape[-3], t_bbox.shape[-2], t_bbox,
                           row_offset)
    return torch.stack([t_bbox[..., 0] + grid_x, t_bbox[..., 1] + grid_y,
                        t_bbox[..., 2], t_bbox[..., 3]], dim=-1)


def normalize_target_wh(t_bbox: torch.Tensor,
                        scaled_anchors: torch.Tensor) -> torch.Tensor:
    """'mse'-mode target: wh' = sqrt((1e-16 + wh) / anchor) / 2, the inverse
    of the (sigmoid * 2) ** 2 * anchor decode."""
    anchors = scaled_anchors[:, None, None, :]   # (A, 1, 1, 2)
    wh = torch.sqrt((1e-16 + t_bbox[..., 2:]) / anchors) / 2.0
    return torch.cat([t_bbox[..., :2], wh], dim=-1)
