"""``inference.make_rtm_detector`` over an ``RTMUAVDet`` built directly
(``models.build_model`` does not dispatch it), with the configuration's
serving settings: ``detect(frames) -> (boxes, scores, valid)``.

The configuration gives the anchors in pixels, as ``reference/detect.py``
decodes them; the model takes them in grid cells, so each head's are
divided back by its stride, ``input_size`` over its grid
(``rtm_det_scales``).

The model keeps PyTorch's default (NCHW) layout, as the program's own
``utils.seeding.seeded_rtm_model`` builds it: with its convolutions
channels_last, as ``program.build`` lays out the other models, a call at
8 x 640 took 22.36 ms against 19.56 (H100 80GB HBM3, 700 W), the
difference mostly layout copies (``direct_copy_kernel``, 3.44 ms a call)."""

import torch


def build(config: dict, state: dict, device, input_size: int):
    from uavdet_tpu_torch.inference import make_rtm_detector
    from uavdet_tpu_torch.models.rtm_uav_det import RTMUAVDet, rtm_det_scales
    dtype = getattr(torch, config["dtype"])
    scales = rtm_det_scales(input_size)
    anchors = [[[a / (input_size // s) for a in anchor] for anchor in head]
               for head, s in zip(config["hparams"]["anchors"], scales,
                                  strict=True)]
    model = RTMUAVDet(anchors, det_scales=scales)
    model.load_state_dict(state)
    model.to(device=device, dtype=dtype).eval()
    d = config["detector"]
    return make_rtm_detector(model, input_size, scales,
                             pre_nms_topk=d["pre_nms_topk"],
                             nms_iou=d["nms_iou"], max_det=d["max_det"],
                             compute_dtype=dtype)
