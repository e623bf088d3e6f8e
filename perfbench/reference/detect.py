"""Heads to detections in plain PyTorch, float32: the reference of the
detector's decode, top-k and NMS.

  1. the objectness logits of all heads, concatenated head by head (anchor,
     row, column within a head), sorted descending and stable; the first
     ``pre_nms_topk`` go on;
  2. each candidate decoded to absolute-pixel xyxy: with s = sigmoid(box
     logits), cx = (2 s0 - 0.5 + column) * stride, cy likewise with the
     row, w = (2 s2)^2 * anchor width, h = (2 s3)^2 * anchor height; the
     stride is input size / the head's width; score = sigmoid(logit);
  3. scores under ``score_threshold`` drop out; greedy NMS in descending
     score order (stable): a box survives when no earlier survivor overlaps
     it with IoU strictly above ``nms_iou``; the first ``max_det``
     survivors are the detections, the rest of the slots zero.
"""

import torch

EPS = 1e-7


def candidates(outs, anchors, input_size: int, k: int) -> dict:
    """Per-head (bbox, obj) logits -> every candidate decoded, and the first
    ``k`` of the stable descending sort of all objectness logits.

    -> ``boxes`` (B, N, 4) xyxy pixels, ``logits`` (B, N), ``stride`` (N,),
    ``anchor`` (N, 2) pixels, in the heads' order (head, anchor, row,
    column); ``heads`` [(offset, A, H, W, stride)]; ``top`` (B, k) the
    indices of the first k."""
    b = outs[0][1].shape[0]
    logits, boxes, strides, sizes, heads = [], [], [], [], []
    offset = 0
    for (bbox, obj), anc in zip(outs, anchors):
        _, a, h, w, _ = obj.shape
        stride = input_size // w
        s = torch.sigmoid(bbox.float())
        gy, gx = torch.meshgrid(torch.arange(h, device=s.device),
                                torch.arange(w, device=s.device),
                                indexing="ij")
        anc = torch.tensor(anc, dtype=torch.float32, device=s.device)
        cx = (s[..., 0] * 2.0 - 0.5 + gx) * stride
        cy = (s[..., 1] * 2.0 - 0.5 + gy) * stride
        bw = (s[..., 2] * 2.0) ** 2 * anc[:, 0, None, None]
        bh = (s[..., 3] * 2.0) ** 2 * anc[:, 1, None, None]
        boxes.append(torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2,
                                  cy + bh / 2], dim=-1).reshape(b, -1, 4))
        logits.append(obj.float().reshape(b, -1))
        strides.append(torch.full((a * h * w,), float(stride),
                                  device=s.device))
        sizes.append(anc[:, None, :].expand(a, h * w, 2).reshape(-1, 2))
        heads.append((offset, a, h, w, stride))
        offset += a * h * w
    logits = torch.cat(logits, dim=1)
    k = min(k, logits.shape[1])
    top = torch.sort(logits, dim=1, descending=True, stable=True).indices
    return {"boxes": torch.cat(boxes, dim=1), "logits": logits,
            "stride": torch.cat(strides), "anchor": torch.cat(sizes),
            "heads": heads, "top": top[:, :k]}


def near(cand: dict, centres: torch.Tensor) -> torch.Tensor:
    """(K, 2) box centres -> (K, M) the indices of the candidates whose
    decode can put a centre there: in each head, each anchor of the 3 x 3
    cells around it (a centre lies between -0.5 and 1.5 cells from its
    cell's corner)."""
    out = []
    for offset, a, h, w, stride in cand["heads"]:
        g = torch.ceil(centres / stride - 1.5).long()
        steps = torch.arange(3, device=centres.device)
        gx = (g[:, 0, None] + steps).clamp(0, w - 1)              # (K, 3)
        gy = (g[:, 1, None] + steps).clamp(0, h - 1)
        cell = (gy[:, :, None] * w + gx[:, None, :]).reshape(-1, 9)
        anc = torch.arange(a, device=centres.device) * h * w
        out.append(offset + (anc[None, :, None] + cell[:, None, :])
                   .reshape(len(centres), -1))
    return torch.cat(out, dim=1)


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU (..., N, M) of xyxy boxes (..., N, 4) and (..., M, 4)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]

    def area(x):
        return ((x[..., 2] - x[..., 0]).clamp_min(0)
                * (x[..., 3] - x[..., 1]).clamp_min(0))

    union = area(a)[..., :, None] + area(b)[..., None, :] - inter
    return inter / union.clamp_min(EPS)


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, iou: float,
               max_det: int):
    """One image's boxes (N, 4) and scores (N,) (-inf: dropped) -> the
    indices of the survivors in descending score order, at most max_det."""
    order = torch.sort(scores, descending=True, stable=True).indices
    order = order[torch.isfinite(scores[order])]
    over = (pairwise_iou(boxes[order], boxes[order]) > iou).cpu()
    keep = []
    alive = torch.ones(len(order), dtype=torch.bool)
    for i in range(len(order)):
        if alive[i]:
            keep.append(i)
            alive[i + 1:] &= ~over[i, i + 1:]
    return order[torch.tensor(keep, dtype=torch.long,
                              device=order.device)][:max_det]


def detections(boxes, logits, score_threshold: float, nms_iou: float,
               max_det: int):
    """Candidates (boxes (B, k, 4), logits (B, k)) -> per image (boxes
    (n, 4), scores (n,)) of its detections."""
    out = []
    for bx, lg in zip(boxes, logits):
        scores = torch.sigmoid(lg)
        scores = torch.where(scores >= score_threshold, scores, -torch.inf)
        keep = greedy_nms(bx, scores, nms_iou, max_det)
        out.append((bx[keep], scores[keep]))
    return out
