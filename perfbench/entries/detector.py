"""``inference.make_detector`` over ``models.build_model``'s model, with the
configuration's serving settings: ``detect(frames) -> (boxes, scores,
valid)``."""

import torch

from perfbench import program


def build(config: dict, state: dict, device, input_size: int):
    from uavdet_tpu_torch.inference import make_detector
    dtype = getattr(torch, config["dtype"])
    model = program.build(config, state, dtype, device)
    d = config["detector"]
    return make_detector(model, program.hparams(config), input_size,
                         score_threshold=d["score_threshold"],
                         nms_iou=d["nms_iou"],
                         pre_nms_topk=d["pre_nms_topk"],
                         max_det=d["max_det"], compute_dtype=dtype)
