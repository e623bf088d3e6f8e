"""Plain PyTorch building blocks of the benchmark's reference models.

Everything runs in float32 on NCHW tensors (TF32 is turned off by the
caller). The modules hold their tensors under the state-dict keys of the
published PyTorch detectors, so that one state dict made by the benchmark
loads into the reference and into the program under test alike. Nothing
here imports the program.

``quant``: None computes every convolution and matrix product in float32;
"fp8" is the control of the correctness check, the same reference computed
in float8 where the program computes in bfloat16: the operands and the
output of every convolution and matrix product rounded to float8 e4m3 (one
scale per tensor, taken from its largest magnitude); the products summed in
float32.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale for the whole tensor (its
    largest magnitude maps to the format's largest)."""
    dtype = torch.float8_e4m3fn
    scale = torch.finfo(dtype).max / x.abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


def q(x: torch.Tensor, quant) -> torch.Tensor:
    """An operand or a product's output: in the control, in float8."""
    return x if quant is None else fp8_round(x)


def conv(x, weight, bias=None, stride=1, padding=0, quant=None):
    return q(F.conv2d(q(x, quant), q(weight, quant), bias, stride, padding),
             quant)


def per_sample_conv(x, kernels, bias=None, stride=1, padding=0, quant=None):
    """x (B, C, H, W), kernels (B, O, C, k, k), bias (B, O) or None: sample b
    convolved with its own kernel."""
    outs = [conv(x[i:i + 1], kernels[i], None if bias is None else bias[i],
                 stride, padding, quant) for i in range(x.shape[0])]
    return torch.cat(outs, dim=0)


def matmul(a, b, quant=None):
    return q(torch.matmul(q(a, quant), q(b, quant)), quant)


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d):
    """Inference BatchNorm over dim 1, by the running statistics."""
    shape = [1, -1] + [1] * (x.dim() - 2)
    inv = torch.rsqrt(bn.running_var + bn.eps)
    return ((x - bn.running_mean.reshape(shape))
            * (inv * bn.weight).reshape(shape) + bn.bias.reshape(shape))


class ConvBN(nn.Module):
    """conv (no bias) -> BN -> activation: ``leaky`` LeakyReLU(0.1) (the
    YOLOv3 CNNBlock) or SiLU (ConvModule)."""

    def __init__(self, c_in, c_out, k=1, stride=1, padding=0, act="leaky"):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, k, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(c_out)
        self.act = act

    def forward(self, x, quant=None):
        c = self.conv
        y = batch_norm(conv(x, c.weight, None, c.stride, c.padding, quant),
                       self.bn)
        return F.leaky_relu(y, 0.1) if self.act == "leaky" else F.silu(y)


class Head(nn.Module):
    """Per map a 1x1 objectness conv (A outputs) and a 1x1 box conv (4A):
    -> per map (bbox (B, A, H, W, 4), obj (B, A, H, W, 1))."""

    def __init__(self, channels, n_anchors=3):
        super().__init__()
        self.n_anchors = n_anchors
        self.detection_head = nn.ModuleList(
            nn.ModuleDict(dict(
                obj=nn.ModuleDict(dict(conv_obj=nn.Conv2d(c, n_anchors, 1))),
                bbox=nn.ModuleDict(dict(
                    conv_bbox=nn.Conv2d(c, 4 * n_anchors, 1)))))
            for c in channels)

    def weight_spec(self) -> dict:
        """The heads' draws for ``weights.seeded_state``: convs N(0, 0.1)
        and an objectness bias of -log(99), a prior of 0.01, so that the
        scores start in a trained detector's range."""
        spec = {}
        for h in range(len(self.detection_head)):
            obj = f"detection_head.{h}.obj.conv_obj."
            spec[obj + "weight"] = ("normal", 0.1)
            spec[obj + "bias"] = ("const", -math.log(99.0))
            spec[f"detection_head.{h}.bbox.conv_bbox.weight"] = ("normal",
                                                                  0.1)
        return spec

    def forward(self, maps, quant=None):
        outs = []
        a = self.n_anchors
        for x, head in zip(maps, self.detection_head, strict=True):
            co, cb = head["obj"]["conv_obj"], head["bbox"]["conv_bbox"]
            obj = conv(x, co.weight, co.bias, quant=quant)
            box = conv(x, cb.weight, cb.bias, quant=quant)
            b, _, h, w = obj.shape
            outs.append((box.view(b, a, 4, h, w).permute(0, 1, 3, 4, 2),
                         obj.view(b, a, 1, h, w).permute(0, 1, 3, 4, 2)))
        return outs


def he_std(fan_in: int) -> float:
    return math.sqrt(2.0 / fan_in)
