"""Models of the port."""

from .dy_yolo import DyYOLO
from .dysoem_simfpn import DySOEM_SimFPN
from .registry import DYSOEM, DYYOLO, build_model

__all__ = ["DYSOEM", "DYYOLO", "DySOEM_SimFPN", "DyYOLO", "build_model"]
