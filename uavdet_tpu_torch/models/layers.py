"""Model blocks of the port: ``uavdet_tpu/models/layers.py`` as ``nn.Module``s.

The modules carry the reference's state_dict keys (``conv``/``bn``,
``layers.{r}.{0,1}``, DyConv ``attention.{1,3}`` and ``weights``,
``detection_head.{h}.{obj,bbox}.conv_*``), so a reference Lightning
checkpoint loads with ``load_state_dict`` as it is. Tensors inside are NCHW
(channels_last where the caller made them so); the heads return the
reference's (B, A, H, W, C) layout.
"""

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops.bn_act import bn_act
from ..parallel.batchnorm import global_batch_norm
from ..parallel.experts import mix_slices
from ..parallel.spatial import conv2d_rows, halo_for_conv, sp_sum
from ..utils.datatypes import DetectionResults


def conv_rows(conv: nn.Conv2d, x: torch.Tensor, sp_group) -> torch.Tensor:
    """``conv(x)``, or with ``sp_group`` the same conv of a band of rows
    (``parallel.spatial.conv2d_rows``)."""
    if sp_group is None:
        return conv(x)
    return conv2d_rows(x, conv.weight, conv.bias, conv.stride[0],
                       conv.padding[0], conv.groups, sp_group)


def global_mean(x: torch.Tensor, dims, sp_group) -> torch.Tensor:
    """``x.mean(dims)`` over the whole image where ``x`` holds a band of its
    rows (dims must include the rows, dim -2 of NCHW or 1 of NHWC): the sum
    over the ``sp`` group divided by the global count, in x's dtype, summed
    in float32 at least."""
    if sp_group is None:
        return x.mean(dim=dims)
    n = dist.get_world_size(sp_group)
    count = n * math.prod(x.shape[d] for d in dims)
    acc = torch.promote_types(x.dtype, torch.float32)
    return (sp_sum(x.sum(dim=dims, dtype=acc), sp_group) / count).to(x.dtype)


def fused_epilogue(y: torch.Tensor, bn: nn.BatchNorm2d) -> bool:
    """Whether the epilogue of ``bn`` on the conv output ``y`` takes
    ``ops.bn_act`` (one pass, the kernel on a card): in inference (``bn`` in
    eval mode), autocast off, on a bf16 map. Training (the kernel has no
    backward), autocast and float32 keep PyTorch's BatchNorm, activation
    and add."""
    return (not bn.training and y.dtype == torch.bfloat16
            and not torch.is_autocast_enabled(y.device.type))


def epilogue(y: torch.Tensor, bn: nn.BatchNorm2d, act: str,
             residual: torch.Tensor | None = None) -> torch.Tensor:
    """``act(bn(y)) [+ residual]`` after a block's conv, ``act``
    "leaky_relu" (0.1) or "silu": one ``ops.bn_act`` pass where
    ``fused_epilogue`` says so, else PyTorch's passes."""
    if fused_epilogue(y, bn):
        return bn_act(y, bn, act, residual)
    y = F.leaky_relu(bn(y), 0.1) if act == "leaky_relu" else F.silu(bn(y))
    return y if residual is None else y + residual


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training-mode update of ``running_var``
    takes the biased batch variance, as flax's ``BatchNorm`` does (the JAX
    package's models), where PyTorch's takes the unbiased one: n / (n - 1)
    times larger for n values per channel, 3 % at n = 32. The normalization
    and the update are PyTorch's own pass (cuDNN on the card), on copies of
    the running statistics (autograd keeps them for the backward); then
    per channel the copies go back into the buffers, the variance's batch
    term scaled by (n - 1) / n. Eval mode is ``nn.BatchNorm2d``'s.

    ``process_group`` (set by ``parallel.shard_model``): where it holds more
    than one rank, training mode normalizes over the global batch, the rows
    of every rank (``parallel.global_batch_norm``), with the same rule for
    the running variance; None (the default) or one rank is the above."""

    process_group = None

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        if (self.process_group is not None
                and dist.get_world_size(self.process_group) > 1):
            return global_batch_norm(x, self)
        n = x.numel() // x.shape[1]
        mean, var = self.running_mean.clone(), self.running_var.clone()
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True,
                         self.momentum, self.eps)
        with torch.no_grad():
            # var = (1 - m) old + m v n / (n - 1); from (1 - m) old, going
            # (n - 1) / n of the way to it leaves (1 - m) old + m v
            self.running_var.mul_(1.0 - self.momentum).lerp_(var, 1 - 1 / n)
            self.running_mean.copy_(mean)
            self.num_batches_tracked.add_(1)
        return y


class CNNBlock(nn.Module):
    """Conv -> BN -> LeakyReLU(0.1) [-> + residual]. ``sp_group``: see
    ``conv_rows``; the epilogue: see ``epilogue``."""

    sp_group = None

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, kernel_size, stride, padding,
                              bias=False)
        self.bn = BatchNorm2d(c_out)

    def forward(self, x, residual=None):
        return epilogue(conv_rows(self.conv, x, self.sp_group), self.bn,
                        "leaky_relu", residual)


class ConvModule(nn.Module):
    """Conv (no bias) -> BN -> SiLU (``uavdet_tpu/models/layers.py:88``).
    ``sp_group``: see ``conv_rows``; the epilogue: see ``epilogue``."""

    sp_group = None

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 1,
                 stride: int = 1, padding: int = 0):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, kernel_size, stride, padding,
                              bias=False)
        self.bn = BatchNorm2d(c_out)

    def forward(self, x):
        return epilogue(conv_rows(self.conv, x, self.sp_group), self.bn,
                        "silu")


class ResidualBlock(nn.Module):
    """num_repeats x (1x1 to half the channels -> 3x3 back), with an
    optional skip, which the second block adds after its activation."""

    def __init__(self, channels: int, use_residual: bool = True,
                 num_repeats: int = 1):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.Sequential(CNNBlock(channels, channels // 2, kernel_size=1),
                          CNNBlock(channels // 2, channels, kernel_size=3,
                                   padding=1))
            for _ in range(num_repeats))
        self.use_residual = use_residual
        self.num_repeats = num_repeats

    def forward(self, x):
        for first, second in self.layers:
            x = second(first(x), x if self.use_residual else None)
        return x


class ScalePrediction(nn.Module):
    """3x3 channel-doubling conv feeding a detection head."""

    def __init__(self, c_in: int):
        super().__init__()
        self.conv = CNNBlock(c_in, 2 * c_in, kernel_size=3, padding=1)

    def forward(self, x):
        return self.conv(x)


class DyConvModule(nn.Module):
    """Dynamic convolution: softmax(GAP-MLP / T) over E expert kernels, the
    per-sample kernel mixed from them, then BN -> SiLU (see ``epilogue``).

    3x3: mix the per-sample kernel, then one grouped conv (groups = batch),
    as the reference does. 1x1: mix first, then one batched matmul
    (``uavdet_tpu/models/layers.py:217-225``).

    ``sp_group`` (``parallel.spatial``): x is a band of the image's rows; the
    pool is over the whole image and the 3x3 conv exchanges its halo. Where
    ``weights`` is an ``ep`` slice (``parallel.experts``), the per-sample
    kernels are mixed over the ``ep`` group (``mix_slices``).
    """

    sp_group = None

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, num_experts: int = 4):
        super().__init__()
        # hidden-dim rule of the reference (model/_base.py:36-39)
        hidden = num_experts if c_in == 3 else int(c_in * 0.25) + 1
        self.attention = nn.Sequential(
            nn.AdaptiveAvgPool2d(1),
            nn.Conv2d(c_in, hidden, 1, bias=False),
            nn.ReLU(),
            nn.Conv2d(hidden, num_experts, 1, bias=True))
        self.weights = nn.Parameter(
            torch.empty(num_experts, c_out, c_in, kernel_size, kernel_size))
        self.bn = BatchNorm2d(c_out)
        self.stride = stride
        self.padding = padding

    def attention_weights(self, pooled: torch.Tensor,
                          attn_temp: float) -> torch.Tensor:
        """(B, C) channel means -> (B, E) softmax expert weights, in f32 or
        the means' dtype above it (as the JAX layer's ``promote_types``)."""
        fc1, fc2 = self.attention[1], self.attention[3]
        a = F.relu(F.linear(pooled, fc1.weight.flatten(1).to(pooled.dtype)))
        a = F.linear(a, fc2.weight.flatten(1).to(a.dtype),
                     fc2.bias.to(a.dtype))
        acc = torch.promote_types(a.dtype, torch.float32)
        return torch.softmax(a.to(acc) / attn_temp, dim=-1)

    def mixed(self, attn: torch.Tensor) -> torch.Tensor:
        """(B, E) attentions -> the per-sample kernels (B, O, I, k, k)."""
        if getattr(self.weights, "ep_slice", None) is not None:
            return mix_slices(attn, [self.weights])[0]
        return torch.einsum("eoikl,be->boikl", self.weights, attn)

    def forward(self, x, attn_temp: float):
        b, c, h, w = x.shape
        o, k = self.bn.num_features, self.weights.shape[-1]
        attn = self.attention_weights(global_mean(x, (2, 3), self.sp_group),
                                      attn_temp)
        attn = attn.to(x.dtype)
        if k == 1 and self.stride == 1 and self.padding == 0:
            if getattr(self.weights, "ep_slice", None) is not None:
                kb = self.mixed(attn)[..., 0, 0].transpose(1, 2)
            else:
                kb = torch.einsum("eoi,be->bio", self.weights[..., 0, 0],
                                  attn)
            # NHWC rows: a view when x is channels_last
            y = torch.bmm(x.permute(0, 2, 3, 1).reshape(b, h * w, c), kb)
            y = y.reshape(b, h, w, o).permute(0, 3, 1, 2)
        elif b == 0:
            # a rank without rows (a short batch over ranks): the same
            # graph of parameters, an empty output
            kb = self.mixed(attn)
            y = F.conv2d(x, kb.sum(0), stride=self.stride,
                         padding=self.padding)
        else:
            kb = self.mixed(attn)
            if self.sp_group is not None:
                x = halo_for_conv(x, k, self.stride, self.padding,
                                  self.sp_group)
                pad = (0, self.padding)
            else:
                pad = self.padding
            y = F.conv2d(x.reshape(1, b * c, x.shape[2], w),
                         kb.reshape(b * o, c, k, k),
                         stride=self.stride, padding=pad, groups=b)
            y = y.reshape(b, o, y.shape[-2], y.shape[-1])
            if y.is_cuda:
                # channels_last, as the rest of the network on the card:
                # BatchNorm on the grouped conv's NCHW output takes PyTorch's
                # slow generic kernels there. Not on the CPU, where the rest
                # is NCHW and the channels-last BatchNorm backward sums each
                # channel in float32 one term after another (1 % off in a
                # bias gradient of the tiny DyYOLO at 64 px)
                y = y.contiguous(memory_format=torch.channels_last)
        return epilogue(y, self.bn, "silu")


class YOLOHead(nn.Module):
    """Per-scale 1x1 objectness and box convs -> (B, A, H, W, C) logits.

    ``channels``: the width of each map it is given, in order: DyYOLO's
    scale-prediction taps, or DySOEM_SimFPN's three neck maps."""

    def __init__(self, channels, n_anchors: int = 3):
        super().__init__()
        self.n_anchors = n_anchors
        self.detection_head = nn.ModuleList(
            nn.ModuleDict(dict(
                obj=nn.ModuleDict(dict(conv_obj=nn.Conv2d(ch, n_anchors, 1))),
                bbox=nn.ModuleDict(dict(
                    conv_bbox=nn.Conv2d(ch, n_anchors * 4, 1)))))
            for ch in channels)

    def forward(self, taps):
        outs = []
        a = self.n_anchors
        for tap, head in zip(taps, self.detection_head, strict=True):
            obj = head["obj"]["conv_obj"](tap)
            bbox = head["bbox"]["conv_bbox"](tap)
            b, _, h, w = obj.shape
            outs.append(DetectionResults(
                bbox=bbox.view(b, a, 4, h, w).permute(0, 1, 3, 4, 2),
                obj=obj.view(b, a, 1, h, w).permute(0, 1, 3, 4, 2)))
        return outs

