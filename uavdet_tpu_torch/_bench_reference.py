"""The baseline of the port's bench: the reference's own PyTorch structure.

The interpreter model as the reference project writes it in eager PyTorch:
NCHW tensors, Conv2d + BatchNorm2d + LeakyReLU blocks, and the dynamic conv
of every sample as one ``F.conv2d(groups=B)`` over the batch folded into the
channels. Its modules and state_dict keys are the reference checkpoint's,
which are also the port's (``models/interpreter.py``), so the port's
weights load into it key for key. ``python -m uavdet_tpu_torch.bench``
times it beside the port's detector, on the same card, frames and
post-processing (the port's decode and NMS), so that ``vs_baseline`` is the
port's network against the reference's on the same function.

A copy of the module structure the repository's checkpoint-import test
builds; the port imports nothing from the tests.
"""

import torch
import torch.nn.functional as F
from torch import nn

from .utils.datatypes import DetectionResults


class CNNBlock(nn.Module):
    def __init__(self, c_in, c_out, bn_act=True, **kw):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, bias=not bn_act, **kw)
        self.bn = nn.BatchNorm2d(c_out)
        self.leaky = nn.LeakyReLU(0.1)
        self.use_bn_act = bn_act

    def forward(self, x):
        return self.leaky(self.bn(self.conv(x))) if self.use_bn_act \
            else self.conv(x)


class ResidualBlock(nn.Module):
    def __init__(self, ch, use_residual=True, num_repeats=1):
        super().__init__()
        self.layers = nn.ModuleList(
            [nn.Sequential(CNNBlock(ch, ch // 2, kernel_size=1),
                           CNNBlock(ch // 2, ch, kernel_size=3, padding=1))
             for _ in range(num_repeats)])
        self.use_residual = use_residual
        self.num_repeats = num_repeats

    def forward(self, x):
        for layer in self.layers:
            x = layer(x) + self.use_residual * x
        return x


class ScalePrediction(nn.Module):
    def __init__(self, c_in):
        super().__init__()
        self.conv = CNNBlock(c_in, 2 * c_in, kernel_size=3, padding=1)

    def forward(self, x):
        return self.conv(x)


class DyConv(nn.Module):
    """Attention over ``num_dy`` expert kernels, mixed per sample; the
    batch's convolutions as one grouped conv."""

    def __init__(self, c_in, c_out, kernel_size=3, stride=1, padding=0,
                 num_dy=4):
        super().__init__()
        self.num_dy, self.c_out, self.k = num_dy, c_out, kernel_size
        self.stride, self.padding = stride, padding
        hidden = num_dy if c_in == 3 else int(c_in * 0.25) + 1
        self.attention = nn.Sequential(
            nn.AdaptiveAvgPool2d(1),
            nn.Conv2d(c_in, hidden, 1, bias=False),
            nn.ReLU(inplace=True),
            nn.Conv2d(hidden, num_dy, 1, bias=True))
        self.weights = nn.Parameter(
            torch.randn(num_dy, c_out, c_in, kernel_size, kernel_size))
        self.bn = nn.BatchNorm2d(c_out)
        self.silu = nn.SiLU()

    def forward(self, x, attn_temp):
        b, c = x.shape[:2]
        a = self.attention(x).view(b, -1)
        a = torch.softmax(a / attn_temp, 1)
        filt = torch.mm(a, self.weights.view(self.num_dy, -1)).view(
            b * self.c_out, c, self.k, self.k)
        x = x.reshape(1, b * c, *x.shape[2:])
        x = F.conv2d(x, filt, stride=self.stride, padding=self.padding,
                     groups=b)
        x = x.view(b, self.c_out, *x.shape[2:])
        return self.silu(self.bn(x))


class ReferenceNet(nn.Module):
    """The reference's layer_config interpreter (``layers.{i}``,
    ``yolo_head.detection_head``). ``forward`` takes NHWC frames, as the
    port's detector hands them over, gives the network the reference's
    contiguous NCHW tensor, and returns the heads as the port's
    ``DetectionResults`` (bbox (B, A, H, W, 4), obj (B, A, H, W, 1))."""

    def __init__(self, layer_config, n_anchors=3, attn_temperature=30.0):
        super().__init__()
        self.layers = nn.ModuleList()
        self.attn_temperature = attn_temperature
        c = 3
        head_c = []
        for tok in layer_config:
            if tok[0] == "B":
                self.layers.append(ResidualBlock(c, num_repeats=tok[1]))
            elif tok[0] == "S":
                self.layers += [
                    ResidualBlock(c, use_residual=False, num_repeats=1),
                    CNNBlock(c, c // 2, kernel_size=1),
                    ScalePrediction(c // 2)]
                head_c.append(c)
                c = c // 2
            elif tok[0] == "U":
                self.layers.append(nn.Upsample(scale_factor=2))
                c = c * 3
            elif tok[0] == "DyConv":
                o, k, s = tok[1:]
                self.layers.append(DyConv(c, o, k, s, 1 if k == 3 else 0))
                c = o
            else:
                o, k, s = tok
                self.layers.append(CNNBlock(
                    c, o, kernel_size=k, stride=s,
                    padding=1 if k == 3 else 0))
                c = o

        class Head(nn.Module):
            def __init__(self, chans):
                super().__init__()
                self.detection_head = nn.ModuleList()
                for ch in chans:
                    self.detection_head.append(nn.ModuleDict(dict(
                        obj=nn.ModuleDict(dict(
                            conv_obj=nn.Conv2d(ch, n_anchors, 1))),
                        bbox=nn.ModuleDict(dict(
                            conv_bbox=nn.Conv2d(ch, n_anchors * 4, 1))))))

        self.yolo_head = Head(head_c)
        self.n_anchors = n_anchors

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).contiguous()
        routes, taps = [], []
        for layer in self.layers:
            if isinstance(layer, ScalePrediction):
                taps.append(layer(x))
                continue
            if isinstance(layer, DyConv):
                x = layer(x, self.attn_temperature)
            else:
                x = layer(x)
            if isinstance(layer, ResidualBlock) and layer.num_repeats == 8:
                routes.append(x)
            elif isinstance(layer, nn.Upsample):
                x = torch.cat([x, routes.pop()], dim=1)
        res = []
        for tap, dh in zip(taps, self.yolo_head.detection_head):
            obj = dh["obj"]["conv_obj"](tap)
            bbox = dh["bbox"]["conv_bbox"](tap)
            b, _, h, w = obj.shape
            res.append(DetectionResults(
                bbox=bbox.view(b, self.n_anchors, 4, h, w)
                .permute(0, 1, 3, 4, 2),
                obj=obj.view(b, self.n_anchors, 1, h, w)
                .permute(0, 1, 3, 4, 2)))
        return res


def reference_model(model: nn.Module) -> ReferenceNet:
    """The reference-structure twin of a port interpreter model (DyYOLO or
    BaselineModel): the same layer_config, its weights loaded key for key
    (strict), on the model's device and in its dtype, in eval mode."""
    param = next(model.parameters())
    with torch.device(param.device):
        ref = ReferenceNet(model.tokens, model.yolo_head.n_anchors,
                           model.attn_temperature)
    ref.to(param.dtype).load_state_dict(model.state_dict(), strict=True)
    return ref.eval()
