"""Model blocks of the port: ``uavdet_tpu/models/layers.py`` as ``nn.Module``s.

The modules carry the reference's state_dict keys (``conv``/``bn``,
``layers.{r}.{0,1}``, DyConv ``attention.{1,3}`` and ``weights``,
``detection_head.{h}.{obj,bbox}.conv_*``), so a reference Lightning
checkpoint loads with ``load_state_dict`` as it is. Tensors inside are NCHW
(channels_last where the caller made them so); the heads return the
reference's (B, A, H, W, C) layout.
"""

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..parallel.batchnorm import global_batch_norm
from ..utils.datatypes import DetectionResults


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
    """Conv -> BN -> LeakyReLU(0.1)."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, kernel_size, stride, padding,
                              bias=False)
        self.bn = BatchNorm2d(c_out)

    def forward(self, x):
        return F.leaky_relu(self.bn(self.conv(x)), 0.1)


class ConvModule(nn.Module):
    """Conv (no bias) -> BN -> SiLU (``uavdet_tpu/models/layers.py:88``)."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 1,
                 stride: int = 1, padding: int = 0):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, kernel_size, stride, padding,
                              bias=False)
        self.bn = BatchNorm2d(c_out)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class ResidualBlock(nn.Module):
    """num_repeats x (1x1 to half the channels -> 3x3 back), with an
    optional skip."""

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
        for layer in self.layers:
            x = layer(x) + x if self.use_residual else layer(x)
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
    per-sample kernel mixed from them, then BN -> SiLU.

    3x3: mix the per-sample kernel, then one grouped conv (groups = batch),
    as the reference does. 1x1: mix first, then one batched matmul
    (``uavdet_tpu/models/layers.py:217-225``).
    """

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
        """(B, C) channel means -> (B, E) f32 softmax expert weights."""
        fc1, fc2 = self.attention[1], self.attention[3]
        a = F.relu(F.linear(pooled, fc1.weight.flatten(1).to(pooled.dtype)))
        a = F.linear(a, fc2.weight.flatten(1).to(a.dtype),
                     fc2.bias.to(a.dtype))
        return torch.softmax(a.float() / attn_temp, dim=-1)

    def forward(self, x, attn_temp: float):
        b, c, h, w = x.shape
        e, o, _, k, _ = self.weights.shape
        attn = self.attention_weights(x.mean(dim=(2, 3)), attn_temp)
        attn = attn.to(x.dtype)
        if k == 1 and self.stride == 1 and self.padding == 0:
            kb = torch.einsum("eoi,be->bio", self.weights[..., 0, 0], attn)
            # NHWC rows: a view when x is channels_last
            y = torch.bmm(x.permute(0, 2, 3, 1).reshape(b, h * w, c), kb)
            y = y.reshape(b, h, w, o).permute(0, 3, 1, 2)
        elif b == 0:
            # a rank without rows (a short batch over ranks): the same
            # graph of parameters, an empty output
            kb = torch.einsum("eoikl,be->boikl", self.weights, attn)
            y = F.conv2d(x, kb.sum(0), stride=self.stride,
                         padding=self.padding)
        else:
            kb = torch.einsum("eoikl,be->boikl", self.weights, attn)
            y = F.conv2d(x.reshape(1, b * c, h, w), kb.reshape(b * o, c, k, k),
                         stride=self.stride, padding=self.padding, groups=b)
            y = y.reshape(b, o, y.shape[-2], y.shape[-1])
            if y.is_cuda:
                # channels_last, as the rest of the network on the card:
                # BatchNorm on the grouped conv's NCHW output takes PyTorch's
                # slow generic kernels there. Not on the CPU, where the rest
                # is NCHW and the channels-last BatchNorm backward sums each
                # channel in float32 one term after another (1 % off in a
                # bias gradient of the tiny DyYOLO at 64 px)
                y = y.contiguous(memory_format=torch.channels_last)
        return F.silu(self.bn(y))


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

