"""Models of the port."""

from .dy_yolo import DyYOLO
from .registry import DYYOLO, build_model

__all__ = ["DYYOLO", "DyYOLO", "build_model"]
