"""4-image mosaic augmentation (reference dataset/_helper.py:226-287).

The port of ``uavdet_tpu/data/mosaic.py``: each image is placed into a
(S/2, S/2) quadrant in row-major order; its (single) box is rescaled into
the quadrant; boxes that degenerate (x1>=x2 or y1>=y2) are skipped AND
their quadrant is left blank (the reference's loop only advances the
quadrant index on success).

``mosaic_layout`` is the geometry alone, from the images' (h, w) and the
manifest's boxes: ``DataPipeline(mosaic=True)`` takes a sample's boxes and
its batch membership from it on the host. ``mosaic_canvas`` makes the
pixels on the images' device: each placed image resized into its quadrant
by ``ops.resize.lanczos4_resize``, which is cv2's ``INTER_LANCZOS4`` bit for
bit, so the canvas is the JAX package's exactly.
"""

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..ops.resize import lanczos4_resize


def mosaic_layout(sizes: Sequence[Tuple[int, int]],
                  bboxes: Sequence[np.ndarray],
                  target_size: Tuple[int, int]) -> List[tuple]:
    """Geometry-only mosaic plan: ``[(source_index, quadrant, box), ...]``
    for the sources that get placed — the exact quadrant-advance +
    degenerate-skip semantics of ``create_mosaic_4_img``, computable from
    header-only (h, w) sizes + manifest boxes without decoding a pixel
    (the JAX package's multi-host sharded-decode membership replay relies
    on this)."""
    th, tw = target_size[0], target_size[1]
    qw, qh = tw // 2, th // 2

    out: List[tuple] = []
    quadrant = 0
    for i, ((oh, ow), box) in enumerate(zip(sizes, bboxes)):
        box = np.asarray(box, np.float32).reshape(-1)
        x_off = (quadrant % 2) * qw
        y_off = (quadrant // 2) * qh
        sx, sy = qw / ow, qh / oh

        x1 = x_off + box[0] * sx
        y1 = y_off + box[1] * sy
        x2 = x_off + box[2] * sx
        y2 = y_off + box[3] * sy
        if x1 >= x2 or y1 >= y2:
            continue
        out.append((i, quadrant, [x1, y1, x2, y2]))
        if len(out) >= 4:
            break
        quadrant += 1
    return out


def mosaic_canvas(images: Sequence[torch.Tensor], layout: Sequence[tuple],
                  target_size: Tuple[int, int]) -> torch.Tensor:
    """The (th, tw, 3) uint8 canvas of ``layout`` (``mosaic_layout`` of these
    images): zeros, and each placed image, (H, W, 3) or grey (H, W) uint8,
    resized into its quadrant (a grey one repeated to 3 channels)."""
    th, tw = target_size[0], target_size[1]
    qw, qh = tw // 2, th // 2
    canvas = torch.zeros((th, tw, 3), dtype=torch.uint8,
                         device=images[0].device)
    for i, quadrant, _ in layout:
        x_off = (quadrant % 2) * qw
        y_off = (quadrant // 2) * qh
        resized = lanczos4_resize(images[i], qh, qw)
        if resized.dim() == 2:
            resized = resized[..., None].expand(qh, qw, 3)
        canvas[y_off:y_off + qh, x_off:x_off + qw] = resized
    return canvas


def create_mosaic_4_img(images: List[torch.Tensor], bboxes: List[np.ndarray],
                        target_size: Tuple[int, int] = (640, 640)):
    """-> (the (th, tw, 3) uint8 canvas on the images' device, the placed
    boxes (n, 4) float32 numpy), as the JAX package's function returns
    them."""
    if len(images) < 4 or len(images) != len(bboxes):
        raise ValueError(
            f"mosaic requires >=4 images with one box array each; got "
            f"{len(images)} images / {len(bboxes)} box arrays")
    layout = mosaic_layout([tuple(img.shape[:2]) for img in images], bboxes,
                           target_size)
    return (mosaic_canvas(images, layout, target_size),
            np.asarray([b for _, _, b in layout], np.float32))
