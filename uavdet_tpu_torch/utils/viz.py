"""Visualization helpers (reference utils/postprocess.py:8-45 and
dataset/_helper.py:185-223).

The port's own copy of ``draw_bbox`` from ``uavdet_tpu/utils/viz.py``
(that package imports JAX), for the detect CLI's ``--draw``. cv2 is
imported when called: where it is absent, drawing raises with a message.
"""

from typing import Optional

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("drawing boxes needs OpenCV (cv2), which this "
                           "host does not have; run without --draw") from e
    return cv2


def draw_bbox(image: np.ndarray, bbox, color=(0, 255, 0), thickness: int = 2,
              label: Optional[str] = None, format: str = "xyxy"):
    """Draw one labelled box on an image (cv2, in place), xyxy or xywh
    format."""
    cv2 = _cv2()

    if format == "xywh":
        x, y, w, h = map(int, bbox)
        x1, y1, x2, y2 = x, y, x + w, y + h
    else:
        x1, y1, x2, y2 = map(int, bbox)

    cv2.rectangle(image, (x1, y1), (x2, y2), color, thickness)
    if label is not None:
        font = cv2.FONT_HERSHEY_SIMPLEX
        (tw, th), base = cv2.getTextSize(label, font, 0.5, 1)
        cv2.rectangle(image, (x1, y1 - th - base - 5), (x1 + tw, y1),
                      color, -1)
        cv2.putText(image, label, (x1, y1 - base - 3), font, 0.5,
                    (255, 255, 255), 1)
    return image


def write_rgb(path: str, image: np.ndarray) -> None:
    """Write an RGB uint8 image with cv2 (which takes BGR)."""
    if not _cv2().imwrite(path, np.ascontiguousarray(image[..., ::-1])):
        raise RuntimeError(f"cv2 could not write {path}")
