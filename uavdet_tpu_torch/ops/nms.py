"""Fixed-shape greedy NMS: ``uavdet_tpu/ops/nms.py`` with its survivor-mask
kernel (``uavdet_tpu/ops/pallas_nms.py``) ported to CUDA (``csrc/nms.cu``).

Semantics, as the reference's: candidates are ranked by a stable descending
sort of the scores (the lower index wins a tie); a box survives iff no
earlier *surviving* box overlaps it with IoU strictly above the threshold;
padding (score -inf) never survives.

``nms_alive`` dispatches on the device of its input: a CPU tensor takes the
plain PyTorch version ``nms_alive_plain``, a CUDA tensor launches the kernel,
anything else raises. Up to ``MAX_BOXES`` boxes per image the kernel keeps
its mask in a cluster's shared memory; above, it keeps the mask rows in a
scratch tensor in device memory (N * ceil(N / 64) * 8 bytes per image, 2 MB
at N = 4096) and takes two launches, counted as one.
"""

import numpy as np
import torch

from .. import kernels
from .boxes import box_iou_pairwise

_BLOCK = 32
MAX_BOXES = 1024   # per image, what a cluster's shared memory holds
# per image, what the walk's shared memory of removed words holds (48 KB)
MAX_BOXES_LARGE = 64 * 6144

# (kind, B, N) at the edges of the kernel's layout: 64 ranks per mask word, 8
# blocks per image that take the mask's rows in turn, at most MAX_BOXES boxes
# in shared memory, and the path with the mask in device memory above that.
# ``nms_edge_case`` makes the boxes. The CPU tests hold the plain version
# against the JAX package at these cases, the smoke test the kernel against
# the plain version on the card, bitwise.
NMS_EDGE_CASES = (
    ("crowded", 1, 1),        # one box
    ("crowded", 1, 63),       # a bit short of one word
    ("crowded", 2, 65),       # a bit past one word; N not a multiple of 8
    ("crowded", 16, 512),     # the detector's shape
    ("crowded", 1, 1024),     # the most the shared-memory mask takes
    ("crowded", 2, 1025),     # one box past it: the mask in device memory
    ("crowded", 1, 2048),     # 32 words: every lane of the walk holds one
    ("crowded", 1, 4096),     # 64 words: two per lane
    ("crowded", 3, 100),      # N a multiple of neither 64 nor 8
    ("identical", 2, 130),    # every box the same: one survivor
    ("disjoint", 2, 200),     # no two boxes overlap: all survive
)


def nms_edge_case(kind: str, b: int, n: int, rng: np.random.Generator):
    """-> (boxes (b, n, 4) xyxy, scores (b, n)) f32 numpy arrays, unsorted.

    "crowded": overlapping boxes with exact duplicates of equal score, a run
    of equal scores, zero-area boxes and -inf padding of zero boxes, as the
    detector hands them to NMS; "identical": one box n times; "disjoint":
    boxes on a grid that do not touch.
    """
    scores = rng.uniform(size=(b, n)).astype(np.float32)
    if kind == "identical":
        boxes = np.tile(np.float32([10, 20, 50, 90]), (b, n, 1))
    elif kind == "disjoint":
        cell = np.arange(n)
        xy = np.stack([cell % 16, cell // 16], axis=-1) * 40.0
        boxes = np.broadcast_to(np.concatenate([xy, xy + 30.0], axis=-1),
                                (b, n, 4)).astype(np.float32)
    elif kind == "crowded":
        xy = rng.uniform(0, 200 + n / 2, size=(b, n, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(4, 60, size=(b, n, 2))],
                               axis=-1).astype(np.float32)
        d = n // 8
        boxes[:, d:2 * d] = boxes[:, :d]              # exact duplicates
        scores[:, d:2 * d] = scores[:, :d]            # ... with equal scores
        scores[:, 2 * d:3 * d] = 0.5                  # a run of ties
        boxes[:, 3 * d:3 * d + d // 2, 2:] = \
            boxes[:, 3 * d:3 * d + d // 2, :2]        # zero-area boxes
        pad = n // 10
        boxes[:, n - pad:] = 0.0                      # padding
        scores[:, n - pad:] = -np.inf
    else:
        raise ValueError(f"unknown kind of NMS case {kind!r}")
    return np.ascontiguousarray(boxes), scores


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


def _nms_alive_cuda(boxes_sorted: torch.Tensor, iou_threshold: float,
                    stamps: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel; with ``stamps`` (B, 3) int64 on the card, the kernel that
    also writes the global timer in ns at each image's start, after its pair
    mask and after its walk."""
    b, n, four = boxes_sorted.shape
    if four != 4 or boxes_sorted.dtype != torch.float32:
        raise ValueError(f"boxes must be (B, N, 4) float32, got "
                         f"{tuple(boxes_sorted.shape)} {boxes_sorted.dtype}")
    if not (1 <= n <= MAX_BOXES_LARGE and b >= 1):
        raise ValueError(f"the NMS kernel takes 1 to {MAX_BOXES_LARGE} boxes "
                         f"of at least one image, got {n} boxes of {b} "
                         "images")
    if stamps is not None and n > MAX_BOXES:
        raise ValueError(f"the stamped kernel takes at most {MAX_BOXES} boxes")
    boxes_sorted = boxes_sorted.contiguous()
    if boxes_sorted.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned (read as float4)")
    alive = torch.empty((b, n), dtype=torch.bool, device=boxes_sorted.device)
    if n > MAX_BOXES:
        mask = torch.empty((b, n, (n + 63) // 64), dtype=torch.int64,
                           device=boxes_sorted.device)
        kernels.NMS_LARGE(boxes_sorted.data_ptr(), alive.data_ptr(),
                          mask.data_ptr(), b, n, float(iou_threshold),
                          kernels.stream_of(boxes_sorted))
    elif stamps is None:
        kernels.NMS(boxes_sorted.data_ptr(), alive.data_ptr(), b, n,
                    float(iou_threshold), kernels.stream_of(boxes_sorted))
    else:
        kernels.NMS_STAMPED(boxes_sorted.data_ptr(), alive.data_ptr(),
                            stamps.data_ptr(), b, n, float(iou_threshold),
                            kernels.stream_of(boxes_sorted))
    return alive


def nms_phase_ms(boxes_sorted: torch.Tensor, iou_threshold: float = 0.5):
    """One launch of the kernel on CUDA boxes with the card's global timer
    read inside it -> (ms of the pair mask, ms of the walk), each the
    largest over the images (they run side by side). A measuring aid: no
    path calls it."""
    stamps = torch.zeros((boxes_sorted.shape[0], 3), dtype=torch.int64,
                         device=boxes_sorted.device)
    _nms_alive_cuda(boxes_sorted, iou_threshold, stamps)
    t = stamps.cpu()
    return (float((t[:, 1] - t[:, 0]).max()) * 1e-6,
            float((t[:, 2] - t[:, 1]).max()) * 1e-6)


def nms_empty_launch(batch: int) -> None:
    """The kernel's grid for ``batch`` images (clusters, block size) with no
    work in it, on the current stream: what a launch of that shape alone
    costs on the card. A measuring aid: no path calls it."""
    kernels.NMS_EMPTY(batch, torch.cuda.current_stream().cuda_stream)


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
