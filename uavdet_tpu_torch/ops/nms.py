"""Fixed-shape greedy NMS: ``uavdet_tpu/ops/nms.py`` with its survivor-mask
kernel (``uavdet_tpu/ops/pallas_nms.py``) ported to CUDA (``csrc/nms.cu``).

Semantics, as the reference's: candidates are ranked by a stable descending
sort of the scores (the lower index wins a tie); a box survives iff no
earlier *surviving* box overlaps it with IoU strictly above the threshold;
padding (score -inf) never survives.

``nms_alive`` dispatches on the device of its input: a CPU tensor takes the
plain PyTorch version ``nms_alive_plain``, a CUDA tensor launches the kernel,
anything else raises.
"""

import torch

from .. import kernels
from .boxes import box_iou_pairwise

_BLOCK = 32


def nms_alive_plain(boxes_sorted: torch.Tensor,
                    iou_threshold: float = 0.5) -> torch.Tensor:
    """Survivor mask (B, N) bool of score-sorted xyxy boxes (B, N, 4).

    The reference's blocked recurrence (``uavdet_tpu/ops/nms.py:54-79``) with
    the batch dimension written out: within a block of 32 ranks the
    recurrence runs rank by rank, then the block's survivors suppress every
    later rank at once. Sizes that are not a multiple of 32 run rank by rank.
    """
    b, n, _ = boxes_sorted.shape
    iou = box_iou_pairwise(boxes_sorted, boxes_sorted)
    tri = torch.ones((n, n), dtype=torch.bool,
                     device=boxes_sorted.device).tril(-1)
    # suppressors[b, v, s]: s ranks above v and overlaps it
    suppressors = (iou > iou_threshold) & tri
    alive = torch.ones((b, n), dtype=torch.bool, device=boxes_sorted.device)
    if n % _BLOCK:
        for i in range(n):
            alive &= ~(suppressors[:, :, i] & alive[:, i:i + 1])
        return alive
    for base in range(0, n, _BLOCK):
        blk = alive[:, base:base + _BLOCK].clone()
        sub = suppressors[:, base:base + _BLOCK, base:base + _BLOCK]
        for i in range(_BLOCK):
            blk &= ~(sub[:, :, i] & blk[:, i:i + 1])
        cols = suppressors[:, :, base:base + _BLOCK]
        alive &= ~torch.any(cols & blk[:, None, :], dim=2)
        alive[:, base:base + _BLOCK] = blk
    return alive


def _nms_alive_cuda(boxes_sorted: torch.Tensor,
                    iou_threshold: float) -> torch.Tensor:
    b, n, four = boxes_sorted.shape
    if four != 4 or boxes_sorted.dtype != torch.float32:
        raise ValueError(f"boxes must be (B, N, 4) float32, got "
                         f"{tuple(boxes_sorted.shape)} {boxes_sorted.dtype}")
    max_n = kernels.library().uavdet_nms_max_boxes()
    if n > max_n:
        raise ValueError(f"the NMS kernel takes at most {max_n} boxes, "
                         f"got {n}")
    alive = torch.empty((b, n), dtype=torch.bool, device=boxes_sorted.device)
    if b == 0 or n == 0:
        return alive
    boxes_sorted = boxes_sorted.contiguous()
    if boxes_sorted.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned (read as float4)")
    kernels.NMS(boxes_sorted.data_ptr(), alive.data_ptr(), b, n,
                float(iou_threshold), kernels.stream_of(boxes_sorted))
    return alive


def nms_alive(boxes_sorted: torch.Tensor,
              iou_threshold: float = 0.5) -> torch.Tensor:
    """Survivor mask (B, N) bool of score-sorted boxes (B, N, 4)."""
    if boxes_sorted.is_cuda:
        return _nms_alive_cuda(boxes_sorted, iou_threshold)
    if boxes_sorted.device.type == "cpu":
        return nms_alive_plain(boxes_sorted, iou_threshold)
    raise ValueError(f"no NMS for device {boxes_sorted.device}")


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                iou_threshold: float = 0.5, max_keep: int | None = None,
                alive_fn=nms_alive):
    """Greedy NMS per image: boxes (B, N, 4) xyxy, scores (B, N).

    -> (keep_idx (B, K) int64 padded with -1, alive (B, N) bool in sorted
    order, order (B, N) int64), the return contract of the reference's
    ``batched_nms``. ``alive_fn`` computes the survivor mask; it is
    ``nms_alive`` unless a caller holds the kernel against its plain version.
    """
    b, n = scores.shape
    order = torch.argsort(-scores, dim=1, stable=True)
    boxes_s = torch.gather(boxes, 1, order[..., None].expand(b, n, 4))
    alive = alive_fn(boxes_s, iou_threshold)
    # padding (score = -inf) is never a real detection
    alive = alive & torch.isfinite(torch.gather(scores, 1, order))
    k = n if max_keep is None else max_keep
    # stable sort alive-first to collect the survivors at the front
    ranks = torch.arange(n, device=scores.device).expand(b, n)
    pick = torch.argsort(torch.where(alive, ranks, n), dim=1,
                         stable=True)[:, :k]
    keep_idx = torch.where(torch.gather(alive, 1, pick),
                           torch.gather(order, 1, pick), -1)
    return keep_idx, alive, order


def nms(boxes: torch.Tensor, scores: torch.Tensor,
        iou_threshold: float = 0.5, max_keep: int | None = None):
    """One image: boxes (N, 4), scores (N,) -> (keep_idx, alive, order)."""
    keep_idx, alive, order = batched_nms(boxes[None], scores[None],
                                         iou_threshold, max_keep)
    return keep_idx[0], alive[0], order[0]
