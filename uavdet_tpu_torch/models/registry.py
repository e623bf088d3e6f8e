"""Model dispatch by config name: ``uavdet_tpu/models/registry.py``.

``DYYOLO`` and ``DYSOEM`` hold the hyper-parameters of
``conf/model/dy-yolo.yaml`` and ``conf/model/dy-soem_fpn.yaml`` that
inference needs, as Python constants, so that the port runs where PyYAML is
not installed. A test holds each equal to its YAML file.
"""

from types import SimpleNamespace

import torch

from .dy_yolo import DyYOLO
from .dysoem_simfpn import DySOEM_SimFPN

DYYOLO = SimpleNamespace(
    anchors=(((199, 73), (315, 92), (268, 182)),
             ((91, 54), (120, 75), (157, 60)),
             ((29, 23), (48, 30), (67, 38))),
    head_scales=(32, 16, 8),
    attn_temperature=30.0,
    layer_config=(
        ("DyConv", 32, 3, 1),
        ("DyConv", 64, 3, 2),
        ("B", 1),
        (128, 3, 2),
        ("B", 2),
        (256, 3, 2),
        ("B", 8),
        (512, 3, 2),
        ("B", 8),
        (1024, 3, 2),
        ("B", 4),
        ("DyConv", 512, 1, 1),
        (1024, 3, 1),
        ("S",),
        (256, 1, 1),
        ("U",),
        ("DyConv", 256, 1, 1),
        (512, 3, 1),
        ("S",),
        (128, 1, 1),
        ("U",),
        ("DyConv", 128, 1, 1),
        (256, 3, 1),
        ("S",),
    ),
)

# anchors smallest first: the x0 (highest-resolution) head comes first. The
# detector takes the head strides (2, 4, 8) from the shapes, not from
# ``head_scales``, which the reference's file has wrong.
DYSOEM = SimpleNamespace(
    anchors=(((29, 23), (48, 30), (67, 38)),
             ((91, 54), (120, 75), (157, 60)),
             ((199, 73), (315, 92), (268, 182))),
    head_scales=(32, 16, 8),
    attention_temperature=30.0,
    num_dy_conv=(3, 3, 3),
    dy_kernel_size=(3, 3, 3),
)

_NOT_PORTED = {
    "baseline": "queue 1 of ROADMAP.md: preprocess_dual and BaselineModel",
}


def serving_dtype(device) -> torch.dtype:
    """The parameter dtype a model gets when the caller names none: bfloat16
    on a CUDA device, where the kernels take bf16 operands (a float32
    DySOEM_SimFPN cannot serve there at all), float32 anywhere else."""
    return (torch.bfloat16 if torch.device(device).type == "cuda"
            else torch.float32)


def build_model(name: str, hparams, dtype: torch.dtype | None = None,
                device="cuda"):
    """Build the named model from a hyper-parameter node (DyYOLO:
    ``layer_config``, ``anchors``, ``attn_temperature``; DySOEM_SimFPN:
    ``num_dy_conv``, ``dy_kernel_size``, ``anchors``,
    ``attention_temperature``). ``dtype``: the dtype of the parameters,
    which is the compute dtype of the forward; None is ``serving_dtype`` of
    the device (bf16 on the card). ``device``: where the model
    is built; the card unless the caller names another (without a card the
    default raises PyTorch's own error)."""
    if name in ("DyYOLO", "DySOEM_SimFPN"):
        with torch.device(device):
            if name == "DyYOLO":
                model = DyYOLO(
                    hparams.layer_config, n_anchors=len(hparams.anchors[0]),
                    attn_temperature=float(hparams.attn_temperature))
            else:
                model = DySOEM_SimFPN(
                    num_dy_conv=tuple(hparams.num_dy_conv),
                    dy_kernel_size=tuple(hparams.dy_kernel_size),
                    attn_temperature=float(hparams.attention_temperature),
                    n_anchors=len(hparams.anchors[0]))
        return model.to(serving_dtype(device) if dtype is None else dtype)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported yet ({_NOT_PORTED[name]})")
    raise ValueError(f"Model {name} not supported")
