"""Planted faults of a detector entry, for showing that ``correct`` comes
out false when the timed path is broken underneath. Each takes an entry's
``build`` and returns a build of the broken program; the configuration that
the check reads is left as it is.

  box_moved      every box moved by 16 pixels
  score_altered  the best detection of each frame with half its score
  half_batch     the first half of the frames detected, the other half's
                 slots left empty
  nms_off        NMS that suppresses nothing (IoU threshold 1): the best
                 ``max_det`` candidates come out as they are
  nms_loose      NMS at an IoU threshold of 0.9 in place of the
                 configuration's
"""

import torch


def _wrap(cls):
    def fault(build):
        return lambda *a, **k: cls(build(*a, **k))
    return fault


def _nms_at(iou: float):
    def fault(build):
        def broken(config, *a, **k):
            det = dict(config["detector"], nms_iou=iou)
            return build(dict(config, detector=det), *a, **k)
        return broken
    return fault


class Shifted:
    def __init__(self, detect, px=16.0):
        self.detect, self.px = detect, px

    def __call__(self, frames):
        out = self.detect(frames)
        return out._replace(boxes=out.boxes + self.px)


class Rescored:
    def __init__(self, detect):
        self.detect = detect

    def __call__(self, frames):
        out = self.detect(frames)
        scores = out.scores.clone()
        scores[:, 0] *= 0.5
        return out._replace(scores=scores)


class HalfBatch:
    def __init__(self, detect):
        self.detect = detect

    def __call__(self, frames):
        out = self.detect(frames[:len(frames) // 2])
        return type(out)(*(torch.cat([t, torch.zeros_like(t)])
                           for t in out))


FAULTS = {"box_moved": _wrap(Shifted), "score_altered": _wrap(Rescored),
          "half_batch": _wrap(HalfBatch), "nms_off": _nms_at(1.0),
          "nms_loose": _nms_at(0.9)}
