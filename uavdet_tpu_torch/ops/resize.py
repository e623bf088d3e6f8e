"""Resizes as two matrix products.

``bilinear_resize`` is ``uavdet_tpu/ops/resize.py``: the weight matrices
replicate ``jax.image.resize(method='bilinear')``, the 1/scale-widened
triangle kernel when shrinking (antialiased), the plain 2-tap lerp when
enlarging, and taps past the edge dropped and renormalized.

``lanczos4_resize`` is OpenCV's ``cv2.resize(..., INTER_LANCZOS4)`` of uint8
frames, which the JAX package's mosaic calls on the host
(``uavdet_tpu/data/mosaic.py``), bit for bit, in torch ops on the frames'
device. OpenCV's generic resize with 8 taps (``resize.cpp``): output pixel d
of an axis reads source pixels ``floor(f) - 3 ... floor(f) + 4`` with
``f = float((d + 0.5) * scale - 0.5)``, ``scale = 1 / (n_out / n_in)``,
indices clamped to the frame (a replicated border); the Lanczos window of
the fraction, in float32 and normalized to sum 1 (``interpolateLanczos4``),
rounded to integers in units of 1/2048; both passes summed in integers, then
``(v + 2^21) >> 22`` saturated to 0..255. The integer weights of one axis
are a banded (n_in, n_out) matrix (a clamped tap adds its weight to the
edge pixel's row), made on the host once per shape; the two products run in
float64, where every product and partial sum is an integer below 2^53 and
so exact in any order of summation, on the CPU and in cuBLAS alike.
"""

import math
from functools import lru_cache

import numpy as np
import torch

from ..utils.tables import cached_tables


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


@cached_tables(maxsize=32)
def _weights_on(device: torch.device, dtype: torch.dtype, n_in: int,
                n_out: int, weights=resize_weights) -> torch.Tensor:
    """The resize matrix ``weights(n_in, n_out)`` on ``device``, made once
    per shape: a copy from the host at every call would make the host wait
    for the card. Read-only. Made outside inference mode whatever the
    caller's mode: an inference tensor in the cache would break every later
    call under autograd (a model served first, then trained). A CUDA
    graph that reads it keeps it (``utils.tables``)."""
    with torch.inference_mode(False):
        return torch.tensor(weights(n_in, n_out), dtype=dtype, device=device)


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


_S45 = 0.70710678118654752440084436210485
_LANCZOS_CS = ((1, 0), (-_S45, -_S45), (0, 1), (_S45, -_S45), (-1, 0),
               (_S45, _S45), (0, -1), (-_S45, _S45))
_COEF_SCALE = 2048          # OpenCV's INTER_RESIZE_COEF_SCALE, 2^11


def _lanczos4_taps(fx: np.float32) -> np.ndarray:
    """OpenCV's ``interpolateLanczos4`` of the fraction ``fx`` in [0, 1),
    float32 as it computes it, then ``saturate_cast<short>(c * 2048)``
    (round half to even). -> (8,) int64."""
    y0 = -(float(fx) + 3) * math.pi * 0.25
    s0, c0 = math.sin(y0), math.cos(y0)
    coeffs = np.zeros(8, np.float32)
    total = np.float32(0)
    for i, (cs, cc) in enumerate(_LANCZOS_CS):
        y0_ = np.float32(fx + np.float32(3 - i))
        if abs(y0_) >= 1e-6:
            y = -float(y0_) * math.pi * 0.25
            coeffs[i] = np.float32((cs * s0 + cc * c0) / (y * y))
        else:
            coeffs[i] = np.float32(1e30)
        total = np.float32(total + coeffs[i])
    coeffs *= np.float32(1) / total
    return np.clip(np.rint(coeffs * np.float32(_COEF_SCALE)), -32768,
                   32767).astype(np.int64)


@lru_cache(maxsize=None)
def lanczos4_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float64 matrix of one axis's integer weights (units of
    1/2048)."""
    scale = 1.0 / (n_out / n_in)
    out = np.zeros((n_in, n_out), np.float64)
    for d in range(n_out):
        f = np.float32((d + 0.5) * scale - 0.5)
        sx = math.floor(f)
        taps = np.clip(np.arange(sx - 3, sx + 5), 0, n_in - 1)
        np.add.at(out[:, d], taps,
                  _lanczos4_taps(np.float32(f - np.float32(sx))))
    out.flags.writeable = False   # shared by every caller of the cache
    return out


def lanczos4_resize(frames: torch.Tensor, out_h: int,
                    out_w: int) -> torch.Tensor:
    """uint8 frames (..., H, W, C) or one grey frame (H, W) -> the same at
    (out_h, out_w), as ``cv2.resize(frame, (out_w, out_h),
    interpolation=cv2.INTER_LANCZOS4)``, on the frames' device."""
    if frames.dtype != torch.uint8:
        raise ValueError(f"lanczos4_resize takes uint8 frames, got "
                         f"{frames.dtype}")
    grey = frames.dim() == 2
    x = frames[..., None] if grey else frames
    h, w = x.shape[-3:-1]
    wy = _weights_on(x.device, torch.float64, h, out_h, lanczos4_weights)
    wx = _weights_on(x.device, torch.float64, w, out_w, lanczos4_weights)
    v = torch.einsum("...hwc,wW->...hWc", x.to(torch.float64), wx)
    v = torch.einsum("...hWc,hH->...HWc", v, wy)
    # (v + 2^21) >> 22 of the integer v, saturated
    out = torch.floor((v + 2.0 ** 21) * 2.0 ** -22).clamp_(0, 255)
    out = out.to(torch.uint8)
    return out[..., 0] if grey else out
