"""Models of the port."""

from .baseline import BaselineModel
from .dy_yolo import DyYOLO
from .dysoem_simfpn import DySOEM_SimFPN
from .registry import BASELINE, DYSOEM, DYYOLO, build_model

__all__ = ["BASELINE", "DYSOEM", "DYYOLO", "BaselineModel", "DySOEM_SimFPN",
           "DyYOLO", "build_model"]
