"""Visualization helpers (reference utils/postprocess.py:8-45 and
dataset/_helper.py:185-223).

The port's own copy of ``uavdet_tpu/utils/viz.py`` (that package imports
JAX): ``draw_bbox`` for the detect CLI's ``--draw``, ``plot_sample_data``
and ``summarize_model``. cv2 and matplotlib are imported when called: where
cv2 is absent, drawing raises with a message.
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


def plot_sample_data(pipeline, out_path: Optional[str] = None, n: int = 4):
    """Plot the first frame of each of n batches, with its boxes, from a
    ``DataPipeline`` (or any iterable of ``BatchData``) with matplotlib."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 2, figsize=(12, 12))
    axes = axes.flatten()
    shown = 0
    for batch in iter(pipeline):
        img = batch.image[0].float().cpu().numpy()
        boxes = batch.boxes[0].float().cpu().numpy() * img.shape[0]
        mask = batch.box_mask[0].cpu().numpy()
        axes[shown].imshow(img)
        for (x1, y1, x2, y2), valid in zip(boxes, mask):
            if valid:
                axes[shown].add_patch(plt.Rectangle(
                    (x1, y1), x2 - x1, y2 - y1, fill=False,
                    edgecolor="cyan", linewidth=2))
        axes[shown].set_title(f"Sample {shown + 1}")
        axes[shown].axis("off")
        shown += 1
        if shown >= n:
            break
    plt.tight_layout()
    if out_path:
        plt.savefig(out_path)
        plt.close(fig)
    else:  # pragma: no cover
        plt.show()
    return out_path


def summarize_model(model, input_shape=(1, 64, 64, 3)) -> str:
    """A table of ``model``'s modules (the torchinfo role in the
    reference's tooling): each module that holds parameters of its own or
    has no children, with its class, its first output's shape in one
    forward on zeros of ``input_shape`` (NHWC frames in [0, 1]) and its own
    parameter count; then the total."""
    import torch

    shapes = {}

    def hook(name):
        def record(module, args, out):
            t = out[0] if isinstance(out, (tuple, list)) else out
            shapes.setdefault(name, tuple(t.shape)
                              if isinstance(t, torch.Tensor) else "-")
        return record

    rows = [(name, m) for name, m in model.named_modules()
            if name and (next(m.parameters(recurse=False), None) is not None
                         or next(m.children(), None) is None)]
    handles = [m.register_forward_hook(hook(name)) for name, m in rows]
    p0 = next(model.parameters())
    try:
        with torch.no_grad():
            model(torch.zeros(input_shape, dtype=p0.dtype, device=p0.device))
    finally:
        for h in handles:
            h.remove()
    lines = [f"{'module':<40} {'class':<16} {'output':<24} params"]
    for name, m in rows:
        own = sum(p.numel() for p in m.parameters(recurse=False))
        lines.append(f"{name:<40} {type(m).__name__:<16} "
                     f"{str(shapes.get(name, '-')):<24} {own}")
    total = sum(p.numel() for p in model.parameters())
    lines.append(f"total parameters: {total}")
    return "\n".join(lines)
