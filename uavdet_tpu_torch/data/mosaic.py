"""4-image mosaic geometry (reference dataset/_helper.py:226-287).

The port's own copy of ``mosaic_layout`` from ``uavdet_tpu/data/mosaic.py``:
each image is placed into a (S/2, S/2) quadrant in row-major order; its
(single) box is rescaled into the quadrant; boxes that degenerate (x1>=x2
or y1>=y2) are skipped AND their quadrant is left blank (the reference's
loop only advances the quadrant index on success).

The pixel path (``create_mosaic_4_img``) resizes with Lanczos-4, which
torch has no counterpart of; it is not ported yet (ROADMAP queue 1), and
``DataPipeline(mosaic=True)`` raises.
"""

from typing import List, Sequence, Tuple

import numpy as np


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
