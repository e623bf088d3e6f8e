"""Model dispatch by config name: ``uavdet_tpu/models/registry.py``.

``DYYOLO`` holds the hyper-parameters of ``conf/model/dy-yolo.yaml`` that
inference needs, as a Python constant, so that the port runs where PyYAML is
not installed. A test holds it equal to the YAML file.
"""

from types import SimpleNamespace

import torch

from .dy_yolo import DyYOLO

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

_NOT_PORTED = {
    "baseline": "queue 1 of ROADMAP.md: preprocess_dual and BaselineModel",
    "DySOEM_SimFPN": "queue 1 of ROADMAP.md: DySOEM with kernel D",
}


def build_model(name: str, hparams, dtype: torch.dtype | None = None):
    """Build the named model from a hyper-parameter node (attributes
    ``layer_config``, ``anchors``, ``attn_temperature``). ``dtype``: the
    dtype of the parameters, which is the compute dtype of the forward."""
    if name == "DyYOLO":
        model = DyYOLO(hparams.layer_config,
                       n_anchors=len(hparams.anchors[0]),
                       attn_temperature=float(hparams.attn_temperature))
        return model if dtype is None else model.to(dtype)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported yet ({_NOT_PORTED[name]})")
    raise ValueError(f"Model {name} not supported")
