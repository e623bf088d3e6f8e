"""YOLO loss, dense and masked: ``uavdet_tpu/ops/losses.py`` in torch.

Per sample i and head h (the reference's ``YOLOHead.compute_metrics``):
  bbox  += bbox_w  * bbox_loss(decoded[pos], built_target[pos])   masked mean
  obj   += objectness_w * obj_scales_w[h] * BCE(p_obj[pos], iou * t_obj[pos])
  obj   += no_obj_w * BCE(p_obj[~pos], t_obj[~pos])
then summed over heads and averaged over the batch. The masked means are per
(sample, head). The IoU soft labels are detached.

``iou_mode``: 'elementwise' pairs each positive prediction with its own
cell's target; 'col0' is the reference's exact ``ious[:, 0]``: every
positive prediction against the first positive target of its (sample, head)
in (A, S, S) order.

Under ``sp`` (``sp_group``) the heads and targets are a band of the grid's
rows, from ``row_offsets[h]`` on: every masked mean sums its numerator and
denominator over the group before it divides (``parallel.sp_sum``), so the
loss is the whole image's on every rank of the group. 'col0' has no such
form and raises there.
"""

from typing import NamedTuple, Sequence

import torch

from ..parallel.spatial import sp_sum
from .boxes import box_convert, box_iou_elementwise, complete_box_iou
from .decode import add_grid_offsets, decode_predictions, normalize_target_wh


def bce_with_logits(logits: torch.Tensor,
                    targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy on logits (the stable form of
    ``F.binary_cross_entropy_with_logits``, in the reference's order)."""
    return (torch.clamp_min(logits, 0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))


class LossBreakdown(NamedTuple):
    total: torch.Tensor
    bbox: torch.Tensor
    obj: torch.Tensor


def _masked_mean_per_sample(x: torch.Tensor, mask: torch.Tensor,
                            sp_group=None) -> torch.Tensor:
    """Mean of x over all non-batch dims where mask, per sample -> (B,);
    the count is clamped to 1 for an empty mask. With ``sp_group`` the
    numerator and the count are summed over the group first."""
    dims = tuple(range(1, x.ndim))
    num = torch.sum(torch.where(mask, x, 0.0), dim=dims)
    den = torch.sum(torch.broadcast_to(mask, x.shape).to(x.dtype), dim=dims)
    if sp_group is not None:
        num, den = sp_sum(torch.stack([num, den]), sp_group).unbind(0)
    return num / torch.clamp_min(den, 1.0)


def yolo_loss(outs: Sequence, target_grids: Sequence[torch.Tensor], anchors,
              head_scales: Sequence[int], obj_scales_w: Sequence[float],
              bbox_w: float, objectness_w: float, no_obj_w: float,
              bbox_loss_fn: str = "mse",
              iou_mode: str = "elementwise", sp_group=None,
              row_offsets: Sequence[int] | None = None) -> LossBreakdown:
    """The total YOLO loss over all heads. ``outs``: per head (bbox, obj)
    logits (B, A, S, S, 4|1); ``target_grids``: per head (B, A, S, S, 5);
    ``anchors`` (H, A, 2) in pixels (a tensor already on the predictions'
    device is not copied). Computed in the predictions' dtype floored at
    float32. ``sp_group``, ``row_offsets``: see the module docstring."""
    if sp_group is not None and iou_mode == "col0":
        raise ValueError("iou_mode 'col0' pairs every prediction with the "
                         "first target of the whole grid; it has no form "
                         "over bands of rows (sp)")
    row_offsets = row_offsets or (0,) * len(outs)
    dtype = torch.promote_types(outs[0].obj.dtype, torch.float32)
    device = outs[0].obj.device
    anchors = torch.as_tensor(anchors, device=device).to(dtype)
    batch = outs[0].obj.shape[0]
    bbox_losses = torch.zeros((batch,), dtype=dtype, device=device)
    obj_losses = torch.zeros((batch,), dtype=dtype, device=device)

    for h, (out, grid) in enumerate(zip(outs, target_grids)):
        scaled_anchors = anchors[h] / head_scales[h]   # (A, 2) grid units
        p_bbox = out.bbox.to(dtype)                    # (B, A, S, S, 4)
        p_obj = out.obj.to(dtype)[..., 0]              # (B, A, S, S)
        grid = grid.to(dtype)
        t_obj = grid[..., 0]
        t_bbox_raw = grid[..., 1:5]
        pos = t_obj == 1.0

        decoded = decode_predictions(p_bbox, scaled_anchors, bbox_loss_fn,
                                     row_offsets[h])

        # IoU soft labels, detached
        iou_pred = decoded.detach()
        if bbox_loss_fn == "mse":   # w/h into grid units before the IoU
            wh = iou_pred[..., 2:] * scaled_anchors[:, None, None, :]
            iou_pred = torch.cat([iou_pred[..., :2], wh], dim=-1)
        target_for_iou = t_bbox_raw
        if iou_mode == "col0":
            bsz = t_obj.shape[0]
            idx0 = torch.argmax(pos.reshape(bsz, -1).to(torch.int32), dim=1)
            t0 = torch.gather(t_bbox_raw.reshape(bsz, -1, 4), 1,
                              idx0[:, None, None].expand(bsz, 1, 4))
            target_for_iou = torch.broadcast_to(
                t0[:, 0][:, None, None, None, :], t_bbox_raw.shape)
        ious = box_iou_elementwise(
            box_convert(iou_pred, "cxcywh", "xyxy"),
            box_convert(target_for_iou, "cxcywh", "xyxy"))

        # the training target
        if bbox_loss_fn == "mse":
            t_built = normalize_target_wh(t_bbox_raw, scaled_anchors)
        else:
            t_built = add_grid_offsets(t_bbox_raw, row_offsets[h])

        # box loss, masked mean per sample
        if bbox_loss_fn == "mse":
            sq = (decoded - t_built) ** 2
            per_sample = _masked_mean_per_sample(sq, pos[..., None],
                                                 sp_group)
        else:
            ciou_l = 1.0 - complete_box_iou(
                box_convert(decoded, "cxcywh", "xyxy"),
                box_convert(t_built, "cxcywh", "xyxy"))
            per_sample = _masked_mean_per_sample(ciou_l, pos, sp_group)
        bbox_losses = bbox_losses + bbox_w * per_sample

        # objectness loss
        soft = ious.detach() * t_obj
        bce = bce_with_logits(p_obj, soft)
        obj_losses = obj_losses + (objectness_w * obj_scales_w[h]
                                   * _masked_mean_per_sample(bce, pos,
                                                             sp_group))
        bce_neg = bce_with_logits(p_obj, t_obj)   # t_obj == 0 on ~pos
        obj_losses = obj_losses + no_obj_w * _masked_mean_per_sample(
            bce_neg, ~pos, sp_group)

    bbox_total = torch.mean(bbox_losses)
    obj_total = torch.mean(obj_losses)
    return LossBreakdown(total=bbox_total + obj_total, bbox=bbox_total,
                         obj=obj_total)
