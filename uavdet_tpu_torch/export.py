"""Export of the detector: serving without the model's Python code.

Port of ``uavdet_tpu/export.py``. ``export_detector`` traces the whole
program of ``inference.Detector`` (preprocess, model, decode, NMS) with
``torch.export`` and serializes it with ``torch.export.save``; the model's
parameters and buffers travel in the artifact, as the JAX package bakes its
weights into its own. A serving process needs ``load_detector`` and no
model code, config tree or weight file::

    blob = export_detector(model, hparams, input_size=640, batch_size=16)
    open("detector.pt2", "wb").write(blob)
    # serving side:
    det = load_detector(open("detector.pt2", "rb").read())
    boxes, scores, valid = det(frames_uint8)   # (B, S, S, 3) uint8

CLI: ``python -m uavdet_tpu_torch.scripts.export_detector --out
detector.pt2``.

One difference from the JAX artifact, which needs no Python of its package
at all: the port's kernels are operators registered with ``torch.library``
(``torch.ops.uavdet.*``), and a saved program that calls them loads only
where they are registered. ``load_detector`` therefore imports the modules
that register them (``ops/stem.py``, ``ops/nms.py``, ``ops/dyconv.py``,
``ops/block.py``, ``ops/group_norm.py``, ``ops/bn_act.py``), and nothing
under ``models/``.

An artifact is made for the device of the model's parameters, as the JAX
package's is made for a platform: a CPU artifact runs the kernels' plain
versions, a card artifact the kernels (their launch counts advance).
"""

import io
from typing import Callable

import torch

# the native sizes of the dual-stream entry: RGB and infrared frames
DUAL_RGB_HW = (1080, 1920)
DUAL_IR_HW = (512, 640)


def export_detector(model, hparams, input_size: int, batch_size: int,
                    dual: bool = False, **detector_kw) -> bytes:
    """Serialize the end-to-end detector for ``(B, S, S, 3)`` uint8 frames
    (or, with ``dual=True``, native-size RGB (B, 1080, 1920, 3) + infrared
    (B, 512, 640, 3) uint8 frames -> 2B detections).

    ``model`` is in eval mode; ``detector_kw`` goes to ``Detector``
    (score_threshold, nms_iou, pre_nms_topk, max_det, compute_dtype).
    """
    from .inference import Detector

    if model.training:
        raise ValueError("export a model in eval mode: a training-mode "
                         "BatchNorm would update its statistics")
    det = Detector(model, hparams, input_size, dual=dual, **detector_kw)
    device = next(model.parameters()).device
    shapes = ([(batch_size, *DUAL_RGB_HW, 3), (batch_size, *DUAL_IR_HW, 3)]
              if dual else [(batch_size, input_size, input_size, 3)])
    frames = tuple(torch.zeros(s, dtype=torch.uint8, device=device)
                   for s in shapes)
    with torch.no_grad():
        # one real call first: the detector's cached device tables (decode,
        # resize matrices) are then real tensors, which the trace takes as
        # constants of the program; made during the trace, they would be
        # fake tensors left in the caches
        det(*frames)
        program = torch.export.export(det, frames, strict=False)
    # the program would keep its example frames (zeros, 19.7 MB at 640 px
    # and batch 16) and save them beside the weights
    program.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_detector(blob: bytes) -> Callable:
    """Deserialize an ``export_detector`` artifact.

    -> ``det(images) -> (boxes (B, max_det, 4) f32, scores (B, max_det)
    f32, valid (B, max_det) bool)`` (for a dual artifact ``det(rgb, ir)``),
    on the device the artifact was made for. Registers the kernels'
    operators first (see the module's docstring).
    """
    from .ops import bn_act, block, dyconv, group_norm, nms, stem  # noqa: F401

    program = torch.export.load(io.BytesIO(blob))
    module = program.module()
    device = next(iter(program.state_dict.values())).device

    @torch.no_grad()
    def det(*frames):
        return module(*(torch.as_tensor(f, device=device) for f in frames))

    return det
