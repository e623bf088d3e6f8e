"""RTMUAVDet: ``uavdet_tpu/models/rtm_uav_det.py`` as ``nn.Module``s.

The fourth model family, deprecated upstream (reference model/RTMUAVDet.py
:313, "INVALID MODEL CONFIGURATION") and kept runnable for completeness. As
in the JAX package it is not exported from ``models/__init__`` and
``build_model`` does not dispatch it: build ``RTMUAVDet`` directly, serve it
with ``inference.make_rtm_detector`` and train it with
``training.rtm.make_rtm_train_step``.

Blocks, NCHW inside (the model takes NHWC frames, as the port's other
models do), module names those of the flax tree (``utils/weights.py``
``rtm_state_dict_from_flax`` maps it):

* ``RTMConvModule``  Conv (no bias) -> BatchNorm -> SiLU or ReLU; flax
                     momentum 0.97 and eps 1e-3 (torch momentum 0.03)
* ``StemLayer``      the 5x5, stride 2, padding 1 RTMConvModule: 640 px
                     gives 319, which MDyCSP_1's stride-2 base conv takes
                     to 160
* ``MDyConv``        1x1 base RTMConvModule (momentum 0.9, eps 1e-5, ReLU)
                     -> GAP attention -> per-channel scale (``channel_fc``)
                     times one k x k spatial filter per sample
                     (``kernel_fc``), applied to every channel
                     (``spatial_dyconv``), plus the residual
* ``MDyCSPModule``   CSP split with an MDyConv compute path
* ``MDyEncoder``     GroupNorm(1) -> 1x1/3x3/5x5 MDyConvs -> residual ->
                     GroupNorm(1) -> channel MLP with tanh-GELU and dropout
* ``MFDFEncoderModule`` bilinear-upsample cross-scale fusion
                     (``ops.resize.bilinear_resize``, the JAX package's)
* ``RTMHead``        sigmoid heads (in float32) and the grid/anchor decode

The outputs are ``DetectionResults`` in the JAX layout, decoded (not
logits): ``bbox`` (B, A, H, W, 4) cxcywh in grid units and ``obj`` (B, A,
H, W, 1) probabilities, both float32.

Left out, with what they serve: ``stem_folded`` and ``skip_base`` exist
only for ``uavdet_tpu/ops/fold_rtm.py``'s ``fold_rtm_front``, a TPU layout
rewrite that is not ported; the ``impl`` argument and the
``UAVDET_MDYCONV`` switch choose between three formulations of the
per-sample spatial filter that are equal (``tests/test_rtm.py``,
``test_spatial_dyconv_impls_agree``), of which the port keeps one: a
single grouped conv with the channels as the batch (``spatial_dyconv``).

Dropout draws its mask from the ``generator`` passed to ``forward``
(torch's default generator where none is), active in training only.
"""

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.boxes import box_convert, box_iou_pairwise
from ..ops.resize import bilinear_resize
from ..utils.datatypes import DetectionResults
from .layers import BatchNorm2d

# the anchors of the JAX package's cfg4 and cfg5 (bench.py), in pixels,
# the highest-resolution head first
RTM_ANCHORS = (((29, 23), (48, 30), (67, 38)),
               ((91, 54), (120, 75), (157, 60)))


def rtm_det_scales(input_size: int) -> tuple:
    """The two heads' grid sizes at ``input_size`` (strides 4 and 8), as
    the JAX package's benchmark sets them."""
    return (input_size // 4, input_size // 8)


class RTMConvModule(nn.Module):
    """Conv (no bias) -> BatchNorm(eps, torch momentum) -> SiLU or ReLU.
    ``momentum`` is PyTorch's: 1 - flax's."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 1,
                 stride: int = 1, padding: int = 0, eps: float = 1e-3,
                 momentum: float = 0.03, activation: str = "silu"):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, kernel_size, stride, padding,
                              bias=False)
        self.bn = BatchNorm2d(c_out, eps=eps, momentum=momentum)
        self.activation = activation

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.silu(x) if self.activation == "silu" else F.relu(x)


class StemLayer(RTMConvModule):
    def __init__(self, c_in: int, c_out: int):
        super().__init__(c_in, c_out, 5, 2, 1)


def spatial_dyconv(x: torch.Tensor, kernel_w: torch.Tensor,
                   padding: int) -> torch.Tensor:
    """Every channel of sample b of x (B, C, H, W) convolved with the same
    k x k filter ``kernel_w[b]`` (B, k, k): one grouped conv over the
    channels as the batch, (C, B, H, W), with groups = B. A 1x1 filter is a
    scale per sample."""
    b, c, h, w = x.shape
    k = kernel_w.shape[-1]
    kernel_w = kernel_w.to(x.dtype)
    if k == 1:
        return x * kernel_w.reshape(b, 1, 1, 1)
    y = F.conv2d(x.transpose(0, 1), kernel_w.reshape(b, 1, k, k),
                 padding=padding, groups=b)
    return y.transpose(0, 1)


class MDyConv(nn.Module):
    """Base 1x1 conv -> attention on its channel means -> the per-channel
    scale times one spatial filter per sample, plus the base's output."""

    def __init__(self, c_in: int, attention_out_c: int,
                 dy_kernel_size: int = 3, dy_padding: int = 1,
                 dy_channel_size: int | None = None):
        super().__init__()
        c = dy_channel_size or c_in
        self.k = dy_kernel_size
        self.padding = dy_padding
        self.base = RTMConvModule(c_in, c, 1, eps=1e-5, momentum=0.1,
                                  activation="relu")
        self.attention = nn.Linear(c, attention_out_c)
        self.channel_fc = nn.Linear(attention_out_c, c)
        self.kernel_fc = nn.Linear(attention_out_c, dy_kernel_size ** 2)

    def forward(self, x):
        x = self.base(x)
        a = F.relu(self.attention(x.mean(dim=(2, 3))))
        channel_w = self.channel_fc(a)
        kernel_w = self.kernel_fc(a).reshape(-1, self.k, self.k)
        y = spatial_dyconv(x, kernel_w, self.padding)
        return y * channel_w[:, :, None, None] + x


class MDyCSPModule(nn.Module):
    def __init__(self, c_in: int, out_channels: int,
                 reduction_ratio: int = 2,
                 dy_channel_size: int | None = None):
        super().__init__()
        base_out = c_in * 2
        half = base_out // reduction_ratio
        self.base_conv = RTMConvModule(c_in, base_out, 3, 2, 1)
        self.conv1 = RTMConvModule(base_out, half)
        self.conv2 = RTMConvModule(base_out, half)
        self.mdy_conv = MDyConv(half, 16, 3, 1, dy_channel_size)
        self.transition1 = RTMConvModule(dy_channel_size or half, half)
        self.transition2 = RTMConvModule(2 * half, out_channels, 3, 1, 1)

    def forward(self, x):
        x = self.base_conv(x)
        x1 = self.transition1(self.mdy_conv(self.conv1(x)))
        return self.transition2(torch.cat([x1, self.conv2(x)], dim=1))


class Dropout(nn.Module):
    """flax's ``nn.Dropout``: in training, keep each value with probability
    1 - p, scaled by 1 / (1 - p), the mask drawn from ``generator``; the
    identity in eval mode or at p = 0."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x, generator: torch.Generator | None = None):
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=generator, device=x.device,
                          dtype=torch.float32) < 1.0 - self.p
        return torch.where(keep, x / (1.0 - self.p), 0.0)


class MDyEncoder(nn.Module):
    def __init__(self, c_in: int, out_channels: int):
        super().__init__()
        third = c_in // 3
        self.group_norm_in = nn.GroupNorm(1, c_in, eps=1e-5)
        self.mdy_conv_1x1 = MDyConv(c_in, 16, 1, 0, third)
        self.mdy_conv_3x3 = MDyConv(c_in, 16, 3, 1, third)
        self.mdy_conv_5x5 = MDyConv(c_in, 16, 5, 2, third)
        self.group_norm_out = nn.GroupNorm(1, 3 * third, eps=1e-5)
        self.mlp_fc1 = nn.Conv2d(3 * third, c_in, 1)
        self.dropout = Dropout(0.2)
        self.mlp_fc2 = nn.Conv2d(c_in, out_channels, 1)

    def forward(self, x, generator=None):
        residual = x
        x = self.group_norm_in(x)
        x = torch.cat([self.mdy_conv_1x1(x), self.mdy_conv_3x3(x),
                       self.mdy_conv_5x5(x)], dim=1)
        x = self.group_norm_out(x + residual)
        # flax's nn.gelu is the tanh approximation
        x = F.gelu(self.mlp_fc1(x), approximate="tanh")
        return self.mlp_fc2(self.dropout(x, generator))


class MFDFEncoderModule(nn.Module):
    def __init__(self, x1_c_in: int, x2_c_in: int):
        super().__init__()
        self.upsample_conv = nn.Conv2d(x2_c_in, x2_c_in // 4, 3, padding=1)
        self.encoder_x1 = MDyEncoder(x1_c_in + x2_c_in // 4, x1_c_in)
        self.downsample = nn.Conv2d(x1_c_in, x1_c_in, 3, 2, 1)
        self.encoder_x2 = MDyEncoder(x2_c_in + x1_c_in, x2_c_in)

    def forward(self, x1, x2, generator=None):
        _, _, h, w = x2.shape
        up = bilinear_resize(x2.permute(0, 2, 3, 1), 2 * h, 2 * w)
        f = self.upsample_conv(up.permute(0, 3, 1, 2))
        x1 = self.encoder_x1(torch.cat([x1, f], dim=1), generator)
        x2 = torch.cat([x2, self.downsample(x1)], dim=1)
        return x1, self.encoder_x2(x2, generator)


class RTMHead(nn.Module):
    """Per head, 1x1 objectness and box convs, the sigmoid in float32, and
    the decode: centre ``2 s - 0.5 + grid``, size ``(2 s)^2 * anchor``."""

    def __init__(self, anchors, channels: Sequence[int] = (128, 256)):
        super().__init__()
        self.register_buffer("anchors", torch.tensor(
            np.asarray(anchors, np.float32)), persistent=False)
        self.n_heads = len(channels)
        a = self.anchors.shape[1]
        for h, c in enumerate(channels):
            self.add_module(f"obj_{h}", nn.Conv2d(c, a, 1))
            self.add_module(f"bbox_{h}", nn.Conv2d(c, 4 * a, 1))

    def forward(self, feats) -> list:
        outs = []
        for h, f in enumerate(feats):
            anchors = self.anchors[h].float()
            a = anchors.shape[0]
            b, _, hh, ww = f.shape
            obj = torch.sigmoid(getattr(self, f"obj_{h}")(f).float())
            obj = obj.reshape(b, a, 1, hh, ww).permute(0, 1, 3, 4, 2)
            s = torch.sigmoid(getattr(self, f"bbox_{h}")(f).float())
            s = s.reshape(b, a, 4, hh, ww)
            gy, gx = torch.meshgrid(
                torch.arange(hh, dtype=torch.float32, device=f.device),
                torch.arange(ww, dtype=torch.float32, device=f.device),
                indexing="ij")
            bbox = torch.stack([
                s[:, :, 0] * 2 - 0.5 + gx, s[:, :, 1] * 2 - 0.5 + gy,
                (s[:, :, 2] * 2) ** 2 * anchors[:, 0, None, None],
                (s[:, :, 3] * 2) ** 2 * anchors[:, 1, None, None]], dim=-1)
            outs.append(DetectionResults(bbox=bbox, obj=obj))
        return outs


class RTMUAVDet(nn.Module):
    """Stem -> MDyCSP_1 (128) -> MDyCSP_2 (256) -> MFDF neck -> RTMHead;
    heads at strides 4 and 8. ``det_scales`` (the heads' grid sizes) is
    the loss's and the detector's business; the model takes it for the
    JAX package's signature."""

    def __init__(self, anchors=RTM_ANCHORS, input_channels: int = 3,
                 det_scales: Sequence[int] = (160, 80)):
        super().__init__()
        self.det_scales = tuple(det_scales)
        self.stem = StemLayer(input_channels, 32)
        self.MDyCSP_1 = MDyCSPModule(32, 128, dy_channel_size=128)
        self.MDyCSP_2 = MDyCSPModule(128, 256)
        self.neck = MFDFEncoderModule(128, 256)
        self.head = RTMHead(anchors, (128, 256))

    @property
    def dtype(self) -> torch.dtype:
        return next(self.parameters()).dtype

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None):
        """x: (B, H, W, C) NHWC frames in [0, 1]. -> one DetectionResults
        per head, float32. ``generator``: the dropout's, in training."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)   # NCHW view of NHWC memory
        x1 = self.MDyCSP_1(self.stem(x))
        x2 = self.MDyCSP_2(x1)
        return self.head(self.neck(x1, x2, generator))


def filter_high_iou_bboxes(p_bbox: torch.Tensor, p_obj: torch.Tensor,
                           t_bbox: torch.Tensor, iou_threshold: float = 0.5):
    """The JAX package's reconstruction of the reference's missing loss
    helper, over any leading (batch) dims: p_bbox (..., N, 4) xyxy, p_obj
    (..., N), t_bbox (..., M, 4) xyxy -> (the best-IoU prediction of each
    target (..., M, 4), its score (..., M), the objectness target (..., N):
    1 where a prediction overlaps any target with IoU above the threshold).
    Ties go to the first prediction, as ``jnp.argmax`` breaks them."""
    iou = box_iou_pairwise(p_bbox, t_bbox)          # (..., N, M)
    best = iou.argmax(dim=-2)                       # (..., M)
    fb = torch.gather(p_bbox, -2, best[..., None].expand(
        *best.shape, 4))
    fo = torch.gather(p_obj, -1, best)
    t_obj = (iou.amax(dim=-1) > iou_threshold).to(p_obj.dtype)
    return fb, fo, t_obj


def rtm_compute_loss(outs, target_boxes: torch.Tensor, input_size: int,
                     det_scales: Sequence[int] = (160, 80)) -> torch.Tensor:
    """The JAX package's ``rtm_compute_loss``, its per-sample loop
    vectorized: per head and sample, the mean squared error of each
    target's best-IoU prediction (in grid units: the target over
    ``input_size // det_scales[h]``) plus the BCE of the objectness on
    probabilities (eps 1e-7); the sum over heads and samples over the
    batch. target_boxes: (B, M, 4) xyxy pixels. -> float32 scalar."""
    batch = outs[0].bbox.shape[0]
    eps = 1e-7
    total = torch.zeros((), dtype=torch.float32,
                        device=outs[0].bbox.device)
    for h, out in enumerate(outs):
        scale_factor = input_size // det_scales[h]
        p_bbox = out.bbox.reshape(batch, -1, 4)
        p_obj = out.obj.reshape(batch, -1)
        t = target_boxes / scale_factor
        fb, _, t_obj = filter_high_iou_bboxes(
            box_convert(p_bbox, "cxcywh", "xyxy"), p_obj, t)
        bbox_l = ((fb - t) ** 2).mean(dim=(1, 2))
        obj_l = -(t_obj * torch.log(p_obj + eps)
                  + (1 - t_obj) * torch.log(1 - p_obj + eps)).mean(dim=1)
        total = total + (bbox_l + obj_l).sum()
    return total / batch
