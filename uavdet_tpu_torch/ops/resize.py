"""Bilinear resize as two matrix products: ``uavdet_tpu/ops/resize.py``.

The weight matrices replicate ``jax.image.resize(method='bilinear')``: the
1/scale-widened triangle kernel when shrinking (antialiased), the plain
2-tap lerp when enlarging, and taps past the edge dropped and renormalized.
"""

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) f32 resize matrix for one axis."""
    scale = n_out / n_in
    kscale = min(scale, 1.0)
    out = np.zeros((n_in, n_out), np.float64)
    idx = np.arange(n_in)
    for o in range(n_out):
        c = (o + 0.5) / scale - 0.5
        w = np.maximum(0.0, 1.0 - np.abs((idx - c) * kscale))
        s = w.sum()
        out[:, o] = w / s if s > 0 else 0.0
    out = out.astype(np.float32)
    out.flags.writeable = False   # shared by every caller of the cache
    return out


@lru_cache(maxsize=32)
def _weights_on(device: torch.device, dtype: torch.dtype, n_in: int,
                n_out: int) -> torch.Tensor:
    """The resize matrix on ``device``, made once per shape: a copy from the
    host at every call would make the host wait for the card. Read-only."""
    return torch.tensor(resize_weights(n_in, n_out), dtype=dtype,
                        device=device)


def bilinear_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, out_h, out_w, C), dtype kept."""
    _, h, w, _ = x.shape
    y = x
    if h != out_h:
        y = torch.einsum("bhwc,hH->bHwc", y,
                         _weights_on(x.device, x.dtype, h, out_h))
    if w != out_w:
        y = torch.einsum("bhwc,wW->bhWc", y,
                         _weights_on(x.device, x.dtype, w, out_w))
    return y
