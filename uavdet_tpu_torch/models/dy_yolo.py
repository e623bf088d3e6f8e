"""DyYOLO: YOLOv3 with dynamic (conditional) convolutions.

Port of ``uavdet_tpu/models/dy_yolo.py``: the interpreter with the
"DyConv" token and the configured attention temperature. The reference's
flax module nests the interpreter under ``net``; the torch module is the
interpreter itself, so its state_dict keys are the reference checkpoint's.
"""

from .interpreter import YOLOInterpreter


class DyYOLO(YOLOInterpreter):
    pass
