"""BaselineModel: YOLOv3 (Darknet-53 backbone + upsample/concat FPN).

Port of ``uavdet_tpu/models/baseline.py``: the interpreter with no "DyConv"
token in its ``layer_config`` (``conf/model/baseline.yaml``). The
reference's flax module nests the interpreter under ``net``; the torch
module is the interpreter itself, so its state_dict keys are the reference
checkpoint's.
"""

from .interpreter import YOLOInterpreter


class BaselineModel(YOLOInterpreter):
    pass
