"""The frame stage: decode, resize and the training affine, as torch ops on
the pipeline's device.

The counterparts of ``_resize``, ``_affine_matrix``, ``_affine_boxes``,
``_apply_affine`` and ``make_transform`` (``uavdet_tpu/data/pipeline.py``):

* boxes and the affine's matrix stay numpy on the host, copied from the JAX
  package operation for operation, so a sample's boxes (and with them the
  batch's drop-empty membership) are the JAX package's bitwise;
* pixels: ``decode`` (PIL on the CPU, nvJPEG on the card), then a bilinear
  resize (``F.interpolate``, half-pixel centres, as ``cv2.resize`` with
  ``INTER_LINEAR``) rounded to uint8, batched over frames of one source
  size; in training the affine, by ``F.grid_sample`` over the inverse of the
  (2, 3) matrix with pixel-centre coordinates and zero padding (as
  ``cv2.warpAffine`` with ``INTER_LINEAR`` and ``BORDER_CONSTANT`` 0),
  rounded to uint8; then /255 to float32 NHWC.

cv2 interpolates uint8 in fixed point, so a pixel may differ from the JAX
package's by one unit in 255 (``tests/test_torch_data.py`` holds max 1/255
and mean 0.2/255).
"""

import io
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


# ------------------------------------------------------- host: boxes, matrix


def affine_matrix(rng: np.random.Generator, size: int) -> np.ndarray:
    """Random affine about the image center, albumentations-Affine-style:
    the JAX package's ``_affine_matrix``, the same draws in the same
    order."""
    scale = rng.uniform(0.8, 1.2)
    tx = rng.uniform(-0.1, 0.1) * size
    ty = rng.uniform(-0.1, 0.1) * size
    theta = np.deg2rad(rng.uniform(-30, 30))
    shear_x = np.deg2rad(rng.uniform(-15, 15))
    shear_y = np.deg2rad(rng.uniform(-15, 15))

    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, -s], [s, c]])
    shear = np.array([[1, np.tan(shear_x)], [np.tan(shear_y), 1]])
    lin = scale * (rot @ shear)

    center = size / 2
    offset = np.array([center + tx, center + ty]) - lin @ np.array(
        [center, center])
    return np.concatenate([lin, offset[:, None]], axis=1)  # (2, 3)


def affine_boxes(boxes: np.ndarray, mat: np.ndarray, size: int) -> np.ndarray:
    """Corner-transform AABBs under the affine (pixel-free box path)."""
    if len(boxes):
        corners = np.stack([
            boxes[:, [0, 1]], boxes[:, [2, 1]],
            boxes[:, [0, 3]], boxes[:, [2, 3]]], axis=1)  # (N, 4, 2)
        t = corners @ mat[:, :2].T + mat[:, 2]
        boxes = np.concatenate([t.min(axis=1), t.max(axis=1)], axis=-1)
        boxes = boxes.clip(0, size - 1e-3)
    return boxes


def resize_boxes(boxes: np.ndarray, w: int, h: int, size: int) -> np.ndarray:
    """Boxes of a (h, w) frame on the (size, size) grid, in float64 as the
    JAX package's ``_resize`` scales them."""
    if len(boxes):
        boxes = boxes * np.array([size / w, size / h, size / w, size / h])
    return boxes


def box_path(boxes: np.ndarray, w: int, h: int, size: int, train: bool,
             rng=None, mat=None) -> tuple:
    """What the transform does to one sample's boxes: resize, and in
    training the affine and the drop of boxes that degenerate under it.
    -> (float32 boxes, the (2, 3) matrix or None). In training the affine is
    ``mat`` where given (drawn by the caller), else drawn from ``rng``, as
    the JAX package draws it."""
    boxes = resize_boxes(boxes, w, h, size)
    if train:
        if mat is None:
            mat = affine_matrix(rng, size)
        boxes = affine_boxes(boxes, mat, size)
        if len(boxes):
            keep = ((boxes[:, 2] - boxes[:, 0]) > 1.0) & (
                (boxes[:, 3] - boxes[:, 1]) > 1.0)
            boxes = boxes[keep]
    return boxes.astype(np.float32), mat


# --------------------------------------------------------------- decode


def decode_cpu(data: bytes) -> torch.Tensor:
    """(H, W, 3) uint8 RGB by PIL, as the JAX package decodes."""
    from PIL import Image
    with Image.open(io.BytesIO(data)) as im:
        return torch.from_numpy(np.array(im.convert("RGB")))


def image_size(path: str, device) -> tuple:
    """(height, width) of a local image file from its header alone, no
    pixel decoded: PIL's ``Image.open(...).size`` for the CPU, nvJPEG's
    ``nvjpegGetImageInfo`` of the file's first 4 KiB for the card (of all
    of it where the frame header lies further in, behind large EXIF or ICC
    segments)."""
    device = torch.device(device)
    if device.type == "cuda":
        from .jpeg import codec
        with open(path, "rb") as f:
            head = f.read(1 << 12)
            try:
                sizes = codec().info(head)[1]
            except RuntimeError:
                sizes = []
            if not sizes or 0 in sizes[0]:
                sizes = codec().info(head + f.read())[1]
            return tuple(sizes[0])
    from PIL import Image
    with Image.open(path) as im:
        return im.height, im.width


def decode(datas: Sequence[bytes], device) -> List[torch.Tensor]:
    """JPEG bytes -> (H, W, 3) uint8 RGB tensors on ``device``: PIL for the
    CPU, nvJPEG on the card's current stream (with libjpeg's chroma
    upsampling and colour conversion, ``jpeg.ycc_to_rgb``). Raises on any
    other device, and on the card when nvJPEG cannot build, load or
    decode."""
    device = torch.device(device)
    if device.type == "cpu":
        return [decode_cpu(d) for d in datas]
    if device.type == "cuda":
        from . import jpeg
        return jpeg.decode(datas, device)
    raise ValueError(f"no decoder for device {device}")


# ----------------------------------------------------------------- pixels


def _round_u8(x: torch.Tensor) -> torch.Tensor:
    """Round to the uint8 grid (kept in float32)."""
    return x.round_().clamp_(0.0, 255.0)


def resize_frames(frames: Sequence[torch.Tensor], size: int,
                  antialias: bool = False) -> torch.Tensor:
    """(H, W, 3) uint8 frames of any sizes -> (B, 3, size, size) float32 on
    the uint8 grid: one bilinear ``F.interpolate`` per source size.
    ``antialias`` (for the detect CLI) matches PIL's ``BILINEAR`` in place of
    cv2's ``INTER_LINEAR``."""
    dev = frames[0].device
    out = torch.empty((len(frames), 3, size, size), dtype=torch.float32,
                      device=dev)
    groups = {}
    for i, f in enumerate(frames):
        groups.setdefault(tuple(f.shape), []).append(i)
    for (h, w, _), idx in groups.items():
        x = torch.stack([frames[i] for i in idx]).permute(0, 3, 1, 2).float()
        if (h, w) != (size, size):
            x = F.interpolate(x, size=(size, size), mode="bilinear",
                              align_corners=False, antialias=antialias)
        out[torch.as_tensor(idx, device=dev)] = _round_u8(x)
    return out


def warp_frames(x: torch.Tensor, mats: np.ndarray) -> torch.Tensor:
    """(B, 3, S, S) float32 frames under per-frame (2, 3) affines, as
    ``cv2.warpAffine`` with ``INTER_LINEAR`` and a zero border: every output
    pixel centre p samples the input bilinearly at M^-1 p, pixel centres at
    integers, and taps outside the frame read 0. On the uint8 grid."""
    b, _, s, _ = x.shape
    full = np.zeros((b, 3, 3))
    full[:, :2] = mats
    full[:, 2, 2] = 1.0
    inv = torch.as_tensor(np.linalg.inv(full)[:, :2], dtype=torch.float32,
                          device=x.device)[:, :, None, None]  # (B, 2, 1, 1, 3)
    p = torch.arange(s, dtype=torch.float32, device=x.device)
    ys, xs = torch.meshgrid(p, p, indexing="ij")
    # elementwise, not a matrix product: TF32 would move the coordinates
    src = inv[..., 0] * xs + inv[..., 1] * ys + inv[..., 2]     # (B, 2, S, S)
    grid = (src.permute(0, 2, 3, 1) + 0.5) * (2.0 / s) - 1.0
    out = F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=False)
    return _round_u8(out)


def frame_stage(frames: Sequence[torch.Tensor], size: int,
                mats: Optional[Sequence] = None) -> torch.Tensor:
    """Decoded uint8 frames -> (B, size, size, 3) float32 in [0, 1] on their
    device: resize, the affines ``mats`` (training) or none, /255."""
    x = resize_frames(frames, size)
    if mats is not None:
        x = warp_frames(x, np.stack(mats))
    return (x / 255.0).permute(0, 2, 3, 1).contiguous()


def make_transform(input_size: int, train: bool):
    """The per-sample (uint8 image, boxes, rng) -> (float32 image, boxes)
    transform of ``uavdet_tpu.data.pipeline.make_transform``, with the
    pixels through the frame stage on the CPU; numpy in and out."""

    def tf(img, boxes, rng):
        h, w = img.shape[:2]
        boxes, mat = box_path(np.asarray(boxes), w, h, input_size, train,
                              rng)
        frame = torch.tensor(np.asarray(img))
        out = frame_stage([frame], input_size,
                          None if mat is None else [mat])
        return out[0].numpy(), boxes

    return tf
