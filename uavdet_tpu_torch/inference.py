"""End-to-end inference of the port: frames -> detections.

Port of ``uavdet_tpu/inference.py`` (``preprocess``, ``decode_topk_global``,
``make_detector``) for a DyYOLO-style model or a DySOEM_SimFPN:

  1. DyYOLO: uint8 NHWC frames at the detector's size go straight into the
     stem's kernel A (/255 is folded into its weights); other frames are
     resized and normalized by ``preprocess`` first. Any other model: every
     frame goes through ``preprocess``, which only normalizes (/255) frames
     that are already at the detector's size;
  2. DyYOLO: the two-pass dynamic-conv stem (``ops/stem.py``, kernels A and
     B), then the rest of the model. A model without that stem runs whole;
     a bf16 DySOEM_SimFPN runs its three SOEMs through kernel D
     (``ops/dyconv.py``);
  3. one global top-k over the objectness logits of all heads, and the
     decode of the survivors only; the head strides come from the shapes;
  4. greedy NMS (``ops/nms.py``, the NMS kernel), fixed-shape Detections.

A model whose parameters live on a CUDA device runs the kernels; on the CPU
the same code runs their plain PyTorch versions.
"""

from functools import lru_cache
from typing import Sequence

import numpy as np
import torch

from .ops.nms import batched_nms, nms_alive
from .ops.resize import bilinear_resize
from .ops.stem import detector_stem_fast_path
from .utils.datatypes import Detections


def preprocess(images: torch.Tensor, input_size: int,
               compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """uint8/float NHWC frames -> (B, S, S, C) in [0, 1], compute dtype."""
    x = images.float()
    if images.dtype == torch.uint8:
        x = x / 255.0
    return bilinear_resize(x, input_size, input_size).to(compute_dtype)


@lru_cache(maxsize=16)
def _head_tables(device: torch.device, heads: tuple, anchors: tuple,
                 scales: tuple) -> dict:
    """Per-head decode tables on ``device``, built once per detector shape:
    building them at every call would copy them from the host each time,
    and a copy from pageable host memory makes the host wait for the card.

    heads: (A, H, W) per head; anchors: (A*heads, 2) pixels; scales: per
    head. Read-only: every caller of the cache shares them.
    """
    offs = [0]
    for a, h, w in heads:
        offs.append(offs[-1] + a * h * w)

    def t(values, dtype=torch.int64):
        return torch.tensor(values, dtype=dtype, device=device)

    return dict(n=offs[-1], bounds=t(offs[1:-1]), off=t(offs[:-1]),
                hw=t([h * w for _, h, w in heads]),
                ww=t([w for _, _, w in heads]),
                scale=t(scales, torch.float32),
                anchors=t(anchors, torch.float32))


def decode_topk_global(outs, anchors, head_scales: Sequence[int],
                       pre_nms_topk: int):
    """One top-k over the concatenated objectness logits of all heads, then
    the decode of the survivors only.

    The sort is on the logits in their native dtype, stable and descending,
    so ties break by the lowest concatenated index as in the reference (and
    never on the f32 sigmoid, which saturates to 1.0 above a logit of about
    16.6). -> boxes (B, k, 4) xyxy f32, scores (B, k) f32, by descending
    score.
    """
    b = outs[0].obj.shape[0]
    anc = np.asarray(anchors, np.float32)      # (heads, A, 2) pixels
    n_a = anc.shape[1]
    tab = _head_tables(outs[0].obj.device,
                       tuple(tuple(o.obj.shape[1:4]) for o in outs),
                       tuple(map(tuple, anc.reshape(-1, 2).tolist())),
                       tuple(float(s) for s in head_scales))
    k = min(pre_nms_topk, tab["n"])

    logits = torch.cat([o.obj.reshape(b, -1) for o in outs], dim=1)
    bbox = torch.cat([o.bbox.reshape(b, -1, 4) for o in outs], dim=1)
    top_l, top_i = torch.sort(logits, dim=1, descending=True, stable=True)
    top_l, top_i = top_l[:, :k], top_i[:, :k]

    # each candidate's head, then its anchor and grid cell within the head
    hid = (top_i[..., None] >= tab["bounds"]).sum(-1)
    rel = top_i - tab["off"][hid]
    hw = tab["hw"][hid]
    ww = tab["ww"][hid]
    ai = rel // hw
    rem = rel % hw
    gx = (rem % ww).float()
    gy = (rem // ww).float()
    scale = tab["scale"][hid]
    aw = tab["anchors"][hid * n_a + ai, 0]
    ah = tab["anchors"][hid * n_a + ai, 1]

    sel = torch.gather(bbox, 1, top_i[..., None].expand(b, k, 4))
    s = torch.sigmoid(sel.float())
    cx = (s[..., 0] * 2.0 - 0.5 + gx) * scale
    cy = (s[..., 1] * 2.0 - 0.5 + gy) * scale
    w_ = (s[..., 2] * 2.0) ** 2 * aw
    h_ = (s[..., 3] * 2.0) ** 2 * ah
    boxes = torch.stack([cx - w_ / 2, cy - h_ / 2,
                         cx + w_ / 2, cy + h_ / 2], dim=-1)
    return boxes, torch.sigmoid(top_l.float())


def select_detections(boxes: torch.Tensor, scores: torch.Tensor,
                      score_threshold: float, nms_iou: float, max_det: int,
                      alive_fn=nms_alive) -> Detections:
    """Threshold, greedy NMS and the fixed-shape result of score-sorted
    candidates. ``alive_fn`` is the NMS survivor mask (see batched_nms)."""
    # the masked suffix keeps the descending order NMS consumes
    scores = torch.where(scores >= score_threshold, scores, -torch.inf)
    keep_idx, _, _ = batched_nms(boxes, scores, nms_iou, max_det, alive_fn)
    valid = keep_idx >= 0
    safe = keep_idx.clamp_min(0)
    out_b = torch.gather(boxes, 1, safe[..., None].expand(*safe.shape, 4))
    out_s = torch.gather(scores, 1, safe)
    return Detections(boxes=torch.where(valid[..., None], out_b, 0.0),
                      scores=torch.where(valid, out_s, 0.0), valid=valid)


def make_detector(model, hparams, input_size: int,
                  score_threshold: float = 0.001, nms_iou: float = 0.5,
                  pre_nms_topk: int = 512, max_det: int = 300,
                  compute_dtype: torch.dtype = torch.bfloat16):
    """``detect(images) -> Detections`` for NHWC frames (B, H, W, 3), uint8
    at any resolution or float in [0, 1]. The weights are ``model``'s own,
    read at every call; frames are moved to the model's device.

    When the model starts with the DyConv(32,3,1), DyConv(64,3,2) stem, it
    runs through the stem kernels (``detector_stem_fast_path``), and uint8
    frames already at ``input_size`` skip ``preprocess``. For any other
    model, frames already at ``input_size`` are only normalized: the resize
    of ``preprocess`` does nothing at the size it is asked for.
    """
    anchors = np.asarray(hparams.anchors, np.float32)
    stem = detector_stem_fast_path(model)

    @torch.inference_mode()
    def detect(images) -> Detections:
        device = next(model.parameters()).device
        x = torch.as_tensor(images, device=device)
        if not (stem is not None and x.dtype == torch.uint8
                and tuple(x.shape[1:3]) == (input_size, input_size)):
            x = preprocess(x, input_size, compute_dtype)
        outs = stem.tail(stem.stem(x)) if stem is not None else model(x)
        scales = [input_size // o.obj.shape[2] for o in outs]
        boxes, scores = decode_topk_global(outs, anchors, scales,
                                           pre_nms_topk)
        return select_detections(boxes, scores, score_threshold, nms_iou,
                                 max_det)

    return detect
