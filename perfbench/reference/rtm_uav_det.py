"""RTMUAVDet in plain PyTorch, float32: the reference of the benchmark's
``rtm_uav_det`` configuration (the reference repository's
``model/RTMUAVDet.py``).

  stem         5x5 conv stride 2 padding 1, 3 -> 32, BN + SiLU
  2 x MDyCSP   3x3 stride 2 base conv C -> 2C; two 1x1 convs 2C -> C (the
               split); an MDyConv on the first; a 1x1 transition; the cat of
               both halves; a 3x3 transition to 128, then 256 channels
  MDyConv      1x1 base conv (+ BN, ReLU) -> the channel means -> a linear
               layer and ReLU -> a per-channel scale (``channel_fc``) and one
               k x k spatial filter per sample (``kernel_fc``); the filter
               applied to every channel of its sample, times the scale, plus
               the base's output
  MDyEncoder   GroupNorm(1) -> the 1x1, 3x3 and 5x5 MDyConvs side by side,
               each to a third of the channels, their cat plus the input ->
               GroupNorm(1) -> 1x1 conv, tanh-GELU, dropout, 1x1 conv
  MFDF neck    the stride-8 map upsampled 2x (bilinear), a 3x3 conv to a
               quarter of its channels, cat onto the stride-4 map, encoder;
               its output through a 3x3 stride-2 conv, cat onto the stride-8
               map, encoder
  heads        per map a 1x1 objectness conv (A outputs) and a 1x1 box conv
               (4A): the highest resolution first

Frames come in as (B, H, W, 3) floats in [0, 1]. The heads give logits, per
map (bbox (B, A, H, W, 4), obj (B, A, H, W, 1)), which
``reference/detect.py``'s ``candidates`` decodes as RTMUAVDet's own head
does: centre (2 sigmoid - 0.5 + cell) x stride, size (2 sigmoid)^2 x anchor.

Departures from the reference file, none of which changes the mathematics
of inference:

- BatchNorm is inference BatchNorm by the running statistics, each layer
  with its own eps (1e-3; 1e-5 in an MDyConv's base), and GroupNorm(1) is
  written out as the mean and variance over (C, H, W), eps 1e-5;
- dropout is the identity (inference);
- each sample's spatial filter is applied on its own, one convolution of
  that sample's channels (as a batch of one-channel maps) with its filter,
  where the reference file stacks the samples into one grouped conv;
- the 2x bilinear upsample is written out (half-pixel centres, the edge
  clamped), where the reference file calls an interpolation routine;
- the class is marked deprecated upstream ("INVALID MODEL CONFIGURATION")
  and its loss import is broken; inference touches neither;
- the anchors are the caller's (``hparams["anchors"]``, pixels): the
  reference file takes them from its caller too.

The seeded draws (``weights.py``, and ``weight_spec`` here) are those of the
port's ``utils/seeding.py:init_weights`` for RTMUAVDet but for the heads'
convs, N(0, 0.01) in place of N(0, 0.1) (``Head.weight_spec``).
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from .common import batch_norm, conv, matmul, q


class Conv(nn.Conv2d):
    """``nn.Conv2d``'s tensors, computed by ``common.conv`` (the control's
    float8 where ``quant`` says)."""

    def forward(self, x, quant=None):
        return conv(x, self.weight, self.bias, self.stride, self.padding,
                    quant)


class Linear(nn.Linear):
    def forward(self, x, quant=None):
        return matmul(x, self.weight.t(), quant) + self.bias


class ConvModule(nn.Module):
    """Conv (no bias) -> inference BN (its own eps) -> SiLU or ReLU."""

    def __init__(self, c_in, c_out, k=1, stride=1, padding=0, eps=1e-3,
                 act="silu"):
        super().__init__()
        self.conv = Conv(c_in, c_out, k, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(c_out, eps=eps)
        self.act = act

    def forward(self, x, quant=None):
        y = batch_norm(self.conv(x, quant), self.bn)
        return F.silu(y) if self.act == "silu" else F.relu(y)


def group_norm(x: torch.Tensor, gn: nn.GroupNorm) -> torch.Tensor:
    """GroupNorm with one group: each sample normalized by the mean and the
    (biased) variance of all its values, then the per-channel affine."""
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(1, 2, 3), keepdim=True)
    y = (x - mean) * torch.rsqrt(var + gn.eps)
    return y * gn.weight[None, :, None, None] + gn.bias[None, :, None, None]


class SpatialFilter(nn.Module):
    """x (B, C, H, W), filters (B, k, k): every channel of sample b
    convolved with filter b, zero padding ``padding``."""

    def forward(self, x, filters, padding: int, quant=None):
        outs = []
        for b in range(x.shape[0]):
            maps = x[b][:, None]                                # (C, 1, H, W)
            outs.append(conv(maps, filters[b][None, None], None, 1, padding,
                             quant)[:, 0])
        return torch.stack(outs)


class MDyConv(nn.Module):
    def __init__(self, c_in, attention_c, k, padding, c=None):
        super().__init__()
        c = c or c_in
        self.k, self.padding = k, padding
        self.base = ConvModule(c_in, c, 1, eps=1e-5, act="relu")
        self.attention = Linear(c, attention_c)
        self.channel_fc = Linear(attention_c, c)
        self.kernel_fc = Linear(attention_c, k * k)
        self.filter = SpatialFilter()

    def weight_spec(self) -> dict:
        """The draws of ``utils/seeding.py:init_weights`` for RTMUAVDet: the
        spatial filter starts near a small centre tap and the channel scale
        small, so that the branch adds to its residual instead of
        outgrowing it."""
        return {"kernel_fc.weight": ("normal", 0.02),
                "channel_fc.weight": ("normal", 0.1)}

    def forward(self, x, quant=None):
        x = self.base(x, quant)
        a = F.relu(self.attention(x.mean(dim=(2, 3)), quant))
        scale = self.channel_fc(a, quant)
        filters = self.kernel_fc(a, quant).reshape(-1, self.k, self.k)
        y = self.filter(x, filters, self.padding, quant)
        return y * scale[:, :, None, None] + x


class MDyCSP(nn.Module):
    def __init__(self, c_in, out_channels, dy_channel_size=None):
        super().__init__()
        base_out = 2 * c_in
        half = base_out // 2
        self.base_conv = ConvModule(c_in, base_out, 3, 2, 1)
        self.conv1 = ConvModule(base_out, half)
        self.conv2 = ConvModule(base_out, half)
        self.mdy_conv = MDyConv(half, 16, 3, 1, dy_channel_size)
        self.transition1 = ConvModule(dy_channel_size or half, half)
        self.transition2 = ConvModule(2 * half, out_channels, 3, 1, 1)

    def forward(self, x, quant=None):
        x = self.base_conv(x, quant)
        x1 = self.transition1(self.mdy_conv(self.conv1(x, quant), quant),
                              quant)
        return self.transition2(torch.cat([x1, self.conv2(x, quant)], dim=1),
                                quant)


class MDyEncoder(nn.Module):
    def __init__(self, c_in, out_channels):
        super().__init__()
        third = c_in // 3
        self.group_norm_in = nn.GroupNorm(1, c_in, eps=1e-5)
        self.mdy_conv_1x1 = MDyConv(c_in, 16, 1, 0, third)
        self.mdy_conv_3x3 = MDyConv(c_in, 16, 3, 1, third)
        self.mdy_conv_5x5 = MDyConv(c_in, 16, 5, 2, third)
        self.group_norm_out = nn.GroupNorm(1, 3 * third, eps=1e-5)
        self.mlp_fc1 = Conv(3 * third, c_in, 1)
        self.mlp_fc2 = Conv(c_in, out_channels, 1)

    def forward(self, x, quant=None):
        y = group_norm(x, self.group_norm_in)
        y = torch.cat([self.mdy_conv_1x1(y, quant),
                       self.mdy_conv_3x3(y, quant),
                       self.mdy_conv_5x5(y, quant)], dim=1) + x
        y = group_norm(y, self.group_norm_out)
        y = F.gelu(self.mlp_fc1(y, quant), approximate="tanh")
        return self.mlp_fc2(y, quant)


def upsample2(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, 2H, 2W), bilinear: output pixel o of an axis of
    n reads the source at (o + 0.5) / 2 - 0.5, between its floor and the
    next pixel, each clamped to 0 .. n - 1."""
    def axis(n: int):
        pos = (torch.arange(2 * n, device=x.device, dtype=x.dtype) + 0.5) \
            / 2 - 0.5
        lo = torch.floor(pos)
        frac = pos - lo
        lo = lo.long()
        return lo.clamp(0, n - 1), (lo + 1).clamp(0, n - 1), frac

    _, _, h, w = x.shape
    r0, r1, fr = axis(h)
    x = x[:, :, r0] * (1 - fr)[:, None] + x[:, :, r1] * fr[:, None]
    c0, c1, fc = axis(w)
    return x[..., c0] * (1 - fc) + x[..., c1] * fc


class MFDF(nn.Module):
    def __init__(self, x1_c, x2_c):
        super().__init__()
        self.upsample_conv = Conv(x2_c, x2_c // 4, 3, padding=1)
        self.encoder_x1 = MDyEncoder(x1_c + x2_c // 4, x1_c)
        self.downsample = Conv(x1_c, x1_c, 3, 2, 1)
        self.encoder_x2 = MDyEncoder(x2_c + x1_c, x2_c)

    def forward(self, x1, x2, quant=None):
        up = q(upsample2(q(x2, quant)), quant)
        f = self.upsample_conv(up, quant)
        x1 = self.encoder_x1(torch.cat([x1, f], dim=1), quant)
        x2 = torch.cat([x2, self.downsample(x1, quant)], dim=1)
        return x1, self.encoder_x2(x2, quant)


class Head(nn.Module):
    """Per map ``obj_{h}`` (A outputs) and ``bbox_{h}`` (4A), 1x1 convs ->
    per map (bbox (B, A, H, W, 4), obj (B, A, H, W, 1)) logits."""

    def __init__(self, channels, n_anchors):
        super().__init__()
        self.n_maps, self.n_anchors = len(channels), n_anchors
        for h, c in enumerate(channels):
            self.add_module(f"obj_{h}", Conv(c, n_anchors, 1))
            self.add_module(f"bbox_{h}", Conv(c, 4 * n_anchors, 1))

    def weight_spec(self) -> dict:
        """Convs N(0, 0.01) and an objectness bias of -log(99), a prior of
        0.01, as RTMDet's head is initialised (mmdetection), so that the
        scores stay in a trained detector's range at 640 px. The port's
        ``init_weights`` draws these convs from N(0, 0.1): behind
        GroupNorm(1) over a mostly flat frame, a few locations come out many
        deviations high, and at 640 px such heads saturate the float32
        sigmoid (objectness logits above 16.6) in some seeds."""
        spec = {}
        for h in range(self.n_maps):
            spec[f"obj_{h}.weight"] = ("normal", 0.01)
            spec[f"obj_{h}.bias"] = ("const", -math.log(99.0))
            spec[f"bbox_{h}.weight"] = ("normal", 0.01)
        return spec

    def forward(self, maps, quant=None):
        outs, a = [], self.n_anchors
        for h, x in enumerate(maps):
            obj = getattr(self, f"obj_{h}")(x, quant)
            box = getattr(self, f"bbox_{h}")(x, quant)
            b, _, hh, ww = obj.shape
            outs.append((box.view(b, a, 4, hh, ww).permute(0, 1, 3, 4, 2),
                         obj.view(b, a, 1, hh, ww).permute(0, 1, 3, 4, 2)))
        return outs


class RTMUAVDet(nn.Module):
    def __init__(self, hparams):
        super().__init__()
        self.stem = ConvModule(3, 32, 5, 2, 1)
        self.MDyCSP_1 = MDyCSP(32, 128, dy_channel_size=128)
        self.MDyCSP_2 = MDyCSP(128, 256)
        self.neck = MFDF(128, 256)
        self.head = Head((128, 256), len(hparams["anchors"][0]))

    def forward(self, x, quant=None):
        """x (B, H, W, 3) frames in [0, 1] -> per map (bbox, obj) logits."""
        x = q(x.float().permute(0, 3, 1, 2), quant)
        x1 = self.MDyCSP_1(self.stem(x, quant), quant)
        x2 = self.MDyCSP_2(x1, quant)
        return self.head(self.neck(x1, x2, quant), quant)


def build(hparams) -> nn.Module:
    return RTMUAVDet(hparams)
