"""Mean Average Precision — torchmetrics/pycocotools-compatible, host-side.

Replaces torchmetrics ``MeanAveragePrecision`` (reference
utils/metrics.py:88-135): single-class, box_format='cxcywh',
iou_thresholds 0.5:0.05:0.95, max_detection_thresholds=[300]*3,
COCO 101-point recall interpolation, area ranges small/medium/large.

Pure numpy (evaluation happens on the host after the jitted pipeline);
accumulate with ``update(preds, targets)`` per image, then ``compute()``.

The port's own copy of ``uavdet_tpu/ops/map.py`` (that package imports
JAX); ``tests/test_torch_train_optim.py`` holds the two equal. Besides,
``add_detections`` feeds it a batch of the detector's ``Detections``, for
``evaluate`` and ``Trainer.validate``.
"""

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

_AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
_REC_THRS = np.linspace(0.0, 1.0, 101)


def _cxcywh_to_xyxy(b):
    b = np.asarray(b, np.float64).reshape(-1, 4)
    out = np.empty_like(b)
    out[:, 0] = b[:, 0] - b[:, 2] / 2
    out[:, 1] = b[:, 1] - b[:, 3] / 2
    out[:, 2] = b[:, 0] + b[:, 2] / 2
    out[:, 3] = b[:, 1] + b[:, 3] / 2
    return out


def _iou_matrix(a, b):
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clip(0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1]))[:, None]
    area_b = ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]))[None, :]
    return inter / np.maximum(area_a + area_b - inter, 1e-9)


class MeanAveragePrecision:
    """torchmetrics-compatible single-class mAP.

    ``max_detection_thresholds`` mirrors torchmetrics: recall is reported
    once per distinct threshold as ``mar_{t}`` (the reference passes
    ``[max_det]*3`` → one ``mar_300`` key, utils/metrics.py:114-118;
    torchmetrics' own default ``[1, 10, 100]`` yields
    ``mar_1/mar_10/mar_100``). AP uses the LAST threshold, as
    pycocotools/torchmetrics do."""

    def __init__(self, box_format: str = "cxcywh",
                 iou_thresholds: Optional[Sequence[float]] = None,
                 max_det: int = 300,
                 max_detection_thresholds: Optional[Sequence[int]] = None):
        self.box_format = box_format
        self.iou_thresholds = np.asarray(
            iou_thresholds if iou_thresholds is not None
            else [0.5 + 0.05 * i for i in range(10)])
        self.max_detection_thresholds = tuple(
            max_detection_thresholds if max_detection_thresholds is not None
            else [max_det] * 3)
        # stored detections are truncated to the LARGEST threshold (the
        # thresholds need not arrive sorted — torchmetrics sorts them);
        # AP itself uses the largest, like pycocotools' maxDets[-1]
        self.max_det = max(self.max_detection_thresholds)
        self._images: List[dict] = []

    def _to_xyxy(self, boxes):
        boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
        if self.box_format == "cxcywh":
            return _cxcywh_to_xyxy(boxes)
        if self.box_format == "xywh":
            out = boxes.copy()
            out[:, 2:] += out[:, :2]
            return out
        return boxes

    def update(self, pred_boxes, pred_scores, target_boxes):
        """One image: pred boxes+scores and GT boxes (all in box_format)."""
        scores = np.asarray(pred_scores, np.float64).reshape(-1)
        order = np.argsort(-scores, kind="stable")[:self.max_det]
        self._images.append(dict(
            det=self._to_xyxy(pred_boxes)[order],
            scores=scores[order],
            gt=self._to_xyxy(target_boxes)))

    def _evaluate_area(self, area: str, max_det: Optional[int] = None):
        """pycocotools-style accumulate for one area range at one
        max-detections-per-image cap.

        → (ap_per_iou: (T,), ar: (T,)) with -1 where no GT."""
        max_det = self.max_det if max_det is None else max_det
        lo, hi = _AREA_RNG[area]
        T = len(self.iou_thresholds)
        all_scores, all_tp = [], []  # per det: score, tp-flag per threshold
        n_gt = 0

        for img in self._images:
            gt = img["gt"]
            det = img["det"][:max_det]
            scores = img["scores"][:max_det]
            gt_area = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
            gt_ignore = (gt_area < lo) | (gt_area > hi)
            n_gt += int((~gt_ignore).sum())

            # pycocotools matching: GTs sorted non-ignored first; a det
            # takes the free GT with highest IoU ≥ thr, preferring any
            # non-ignored GT over ignored ones
            g_order = np.argsort(gt_ignore, kind="stable")
            gt_s, gt_ig_s = gt[g_order], gt_ignore[g_order]
            iou = _iou_matrix(det, gt_s)
            det_area = (det[:, 2] - det[:, 0]) * (det[:, 3] - det[:, 1])
            det_out_of_range = (det_area < lo) | (det_area > hi)

            tp = np.zeros((T, len(det)), bool)
            ignore_det = np.zeros((T, len(det)), bool)
            for ti, thr in enumerate(self.iou_thresholds):
                taken = np.zeros(len(gt_s), bool)
                for d in range(len(det)):
                    m, best = -1, min(thr, 1.0 - 1e-10)
                    for g in range(len(gt_s)):
                        if taken[g]:
                            continue
                        # past all non-ignored GTs with a match in hand
                        if m > -1 and not gt_ig_s[m] and gt_ig_s[g]:
                            break
                        if iou[d, g] < best:
                            continue
                        m, best = g, iou[d, g]
                    if m == -1:
                        # unmatched det outside the area range → ignored
                        ignore_det[ti, d] = det_out_of_range[d]
                        continue
                    taken[m] = True
                    if gt_ig_s[m]:
                        ignore_det[ti, d] = True
                    else:
                        tp[ti, d] = True
            all_scores.append(scores)
            all_tp.append((tp, ignore_det))

        if n_gt == 0:
            return np.full(T, -1.0), np.full(T, -1.0)

        scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
        order = np.argsort(-scores, kind="mergesort")
        ap = np.zeros(T)
        ar = np.zeros(T)
        for ti in range(T):
            tp = np.concatenate([t[0][ti] for t in all_tp])[order]
            ig = np.concatenate([t[1][ti] for t in all_tp])[order]
            tp, fp = tp[~ig], ~tp[~ig]
            tp_cum = np.cumsum(tp)
            fp_cum = np.cumsum(fp)
            rec = tp_cum / n_gt
            prec = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
            # precision envelope (monotone non-increasing from the right)
            for i in range(len(prec) - 1, 0, -1):
                prec[i - 1] = max(prec[i - 1], prec[i])
            # 101-point interpolation
            idx = np.searchsorted(rec, _REC_THRS, side="left")
            q = np.where(idx < len(prec), prec[np.minimum(idx, max(len(prec) - 1, 0))], 0.0) \
                if len(prec) else np.zeros_like(_REC_THRS)
            ap[ti] = q.mean()
            ar[ti] = rec[-1] if len(rec) else 0.0
        return ap, ar

    def compute(self) -> Dict[str, float]:
        """Full torchmetrics-style result dict (utils/metrics.py:119-135):
        map/map_50/map_75, map_{small,medium,large}, one ``mar_{t}`` per
        distinct max-detections threshold, mar_{small,medium,large} (at the
        last threshold), plus the single-class placeholders torchmetrics
        emits when class_metrics is off."""
        def _mean(v):
            ok = v > -1
            return float(v[ok].mean()) if ok.any() else -1.0

        out = {}
        ap_all, ar_all = self._evaluate_area("all")
        out["map"] = _mean(ap_all)
        t = list(np.round(self.iou_thresholds, 2))
        out["map_50"] = float(ap_all[t.index(0.5)]) if 0.5 in t else -1.0
        out["map_75"] = float(ap_all[t.index(0.75)]) if 0.75 in t else -1.0
        out["mar_max_det"] = _mean(ar_all)  # legacy alias for mar_{last}
        for md in dict.fromkeys(self.max_detection_thresholds):  # distinct
            _, ar = (self._evaluate_area("all", md)
                     if md != self.max_det else (None, ar_all))
            out[f"mar_{md}"] = _mean(ar)
        for area in ("small", "medium", "large"):
            ap, ar = self._evaluate_area(area)
            out[f"map_{area}"] = _mean(ap)
            out[f"mar_{area}"] = _mean(ar)
        # single-class placeholders (torchmetrics with class_metrics=False)
        out["map_per_class"] = -1.0
        out[f"mar_{self.max_det}_per_class"] = -1.0
        out["classes"] = 1
        return out

    def reset(self):
        self._images = []


def calculate_ap(pred_boxes, pred_obj, target_boxes, max_det: int = 300,
                 iou_th=None) -> Dict[str, float]:
    """Single-image convenience wrapper (reference utils/metrics.py:88-135
    signature: cxcywh boxes, single class)."""
    m = MeanAveragePrecision(iou_thresholds=iou_th, max_det=max_det)
    m.update(pred_boxes, pred_obj, target_boxes)
    return m.compute()


def _xyxy_to_cxcywh(b: np.ndarray) -> np.ndarray:
    return np.stack([(b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2,
                     b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], -1)


def add_detections(metric: "MeanAveragePrecision", det, gt_boxes, gt_mask,
                   input_size: int) -> list:
    """Feed one batch's ``Detections`` (xyxy pixels) and its normalized
    ground truth to ``metric`` (cxcywh); -> per image ``{"boxes_xyxy",
    "scores", "gt_xyxy"}`` of the valid detections."""
    boxes = det.boxes.float().cpu().numpy()
    scores = det.scores.float().cpu().numpy()
    valid = det.valid.cpu().numpy()
    gt = torch.as_tensor(gt_boxes).float().cpu().numpy() * input_size
    gt_mask = torch.as_tensor(gt_mask).cpu().numpy()
    out = []
    for i in range(boxes.shape[0]):
        b, s, g = boxes[i][valid[i]], scores[i][valid[i]], gt[i][gt_mask[i]]
        metric.update(_xyxy_to_cxcywh(b), s, _xyxy_to_cxcywh(g))
        out.append({"boxes_xyxy": b, "scores": s, "gt_xyxy": g})
    return out
