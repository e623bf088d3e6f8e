"""The numbers that decide ``correct``, each from the program's output and
the reference's, and the limits they are held to (``limits/<cell>.json``).

Serving, per compared call (every frame of it), against the reference's
candidates (every anchor of every cell of every head, decoded):
  logit_gap  the largest logit error that the program's answer implies:
             for each detection, |logit(score) - the reference logit| of its
             candidate (of those whose decode can put a centre where the
             detection's is, ``reference.detect.near``, the one that
             explains it best: the least of the larger of this gap and the
             box error); for each of the reference's first
             ``pre_nms_topk`` candidates above the score threshold (all of
             them at a threshold of 0: a detector with none) that is no
             detection's candidate, the least error that explains its
             absence: that it fell below the k-th (its logit - the
             reference's k-th), below the last of ``max_det`` kept (its
             logit - the lowest detection's, where all slots are full), or
             under a detection that could have suppressed it
             (``could_suppress`` within ``cover_box`` box error; its logit -
             that detection's, or 0). A detection that is no candidate, a
             wrong score, a missing frame and a wrong top-k or suppression
             of a box that should survive all read high;
  box_gap    over the detections, the largest box error against their
             candidates (``box_errors``: centre in strides, size in
             anchors);
  nms_overlap
             the largest IoU between two detections of one frame (their
             boxes as the program returns them): greedy NMS keeps no two
             above the configuration's ``nms_iou``, whatever the scores
             and boxes, so a kept box that NMS should have removed reads
             above it. Its limit is ``nms_iou`` and room for the rounding
             of IoU in float32.
"""

import json
import math
from pathlib import Path

import torch

from .reference.detect import near, pairwise_iou


ROOT = Path(__file__).resolve().parent


def limits(cell: str) -> dict:
    return json.loads((ROOT / "limits" / f"{cell}.json").read_text())


def _parts(boxes: torch.Tensor):
    return (boxes[..., :2] + boxes[..., 2:]) / 2, boxes[..., 2:] - boxes[..., :2]


def box_errors(boxes: torch.Tensor, cb: torch.Tensor, stride: torch.Tensor,
               anchor: torch.Tensor) -> torch.Tensor:
    """(K, 4) xyxy boxes against their candidates' boxes (K, M, 4), strides
    (K, M) and anchors (K, M, 2) -> (K, M) the largest error of centre (in
    the candidate's strides) and of width and height (in its anchor's):
    about 2 to 8 times the error of the box's sigmoids, at any size of box."""
    c, wh = _parts(boxes[:, None])
    cc, cwh = _parts(cb)
    pos = (c - cc).abs().amax(-1) / stride
    size = ((wh - cwh).abs() / anchor).amax(-1)
    return torch.maximum(pos, size)


def _iou(c, cwh, d, dwh) -> torch.Tensor:
    lt = torch.maximum(c - cwh / 2, d - dwh / 2)
    rb = torch.minimum(c + cwh / 2, d + dwh / 2)
    inter = (rb - lt).clamp_min(0).prod(-1)
    union = cwh.clamp_min(0).prod(-1) + dwh.clamp_min(0).prod(-1) - inter
    return inter / union.clamp_min(1e-7)


def could_suppress(cand: dict, boxes: torch.Tensor, iou: float,
                   tol: float) -> torch.Tensor:
    """(k,) candidates and (K, 4) detections -> (k, K): whether the
    detection overlaps the candidate by more than ``iou`` as it stands, or
    once the candidate's centre is moved toward the detection's by up to
    ``tol`` strides, its size by up to ``tol`` anchors, or both: whether the
    program, whose boxes err by that much, could have seen the overlap.
    Thin boxes make a plain IoU tolerance useless: a pixel-wide box's IoU
    swings with a tenth of a pixel."""
    cc, cwh = _parts(cand["boxes"][:, None])
    dc, dwh = _parts(boxes[None])
    step = (tol * cand["stride"])[:, None, None]
    grow = tol * cand["anchor"][:, None]
    moved = cc + (dc - cc).clamp(-step, step)
    sized = cwh + (dwh - cwh).clamp(-grow, grow)
    best = torch.stack([_iou(cc, cwh, dc, dwh), _iou(moved, cwh, dc, dwh),
                        _iou(cc, sized, dc, dwh),
                        _iou(moved, sized, dc, dwh)]).amax(0)
    return best > iou


def detection_numbers(prog, cand: dict, det: dict) -> dict:
    """One call's numbers. prog: the program's (boxes (B, K, 4), scores
    (B, K), valid (B, K)); cand: the reference's candidates
    (``reference.detect.candidates``); det: the configuration's ``detector``
    settings. -> logit_gap, box_gap, nms_overlap, and apart the detections'
    own logit gap and the absent candidates' (``coverage_gap``)."""
    boxes, scores, valid = (t.float() if t.is_floating_point() else t
                            for t in prog)
    valid = valid.bool()
    iou = pairwise_iou(boxes, boxes)
    pair = valid[:, :, None] & valid[:, None, :]
    pair &= ~torch.eye(pair.shape[1], dtype=torch.bool,
                       device=pair.device)[None]
    overlap = float(torch.where(pair, iou, 0.0).amax()) if pair.numel() \
        else 0.0
    st = det["score_threshold"]
    thr = math.log(st / (1 - st)) if st > 0 else -math.inf
    own = box_gap = cover = 0.0
    for i in range(boxes.shape[0]):
        v = valid[i]
        pb, pl = boxes[i][v], torch.logit(scores[i][v].double()).float()
        top = cand["top"][i]
        cl = cand["logits"][i][top]
        deficit = cl - cl[-1]
        if len(pb):
            idx = near(cand, _parts(pb)[0])                       # (K, M)
            dl = (pl[:, None] - cand["logits"][i][idx]).abs()
            db = box_errors(pb, cand["boxes"][i][idx], cand["stride"][idx],
                            cand["anchor"][idx])
            j = torch.maximum(dl, db).argmin(dim=1)
            rows = torch.arange(len(pb), device=pb.device)
            own = max(own, float(dl[rows, j].max()))
            box_gap = max(box_gap, float(db[rows, j].max()))
            if len(pb) >= det["max_det"]:
                deficit = torch.minimum(deficit, cl - pl.min())
            mine = {"boxes": cand["boxes"][i][top],
                    "stride": cand["stride"][top],
                    "anchor": cand["anchor"][top]}
            over = could_suppress(mine, pb, det["nms_iou"], det["cover_box"])
            under = (cl[:, None] - pl[None, :]).clamp_min(0.0)
            deficit = torch.minimum(deficit, torch.where(
                over, under, torch.inf).amin(dim=1))
            deficit[torch.isin(top, idx[rows, j])] = 0.0
        due = deficit[cl >= thr]
        if len(due):
            cover = max(cover, float(due.max()))
    return {"logit_gap": max(own, cover), "box_gap": box_gap,
            "nms_overlap": overlap, "detection_gap": own,
            "coverage_gap": cover}


def judge(numbers: dict, lims: dict) -> dict:
    """-> {name: {"value", "limit"}} for every number that has a limit."""
    return {k: {"value": numbers[k], "limit": lims[k]} for k in lims}
