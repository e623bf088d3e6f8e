"""DyYOLO in plain PyTorch, float32: the reference of the benchmark's
``dyyolo`` configuration.

YOLOv3 (Darknet-53 with its FPN) built from the configuration's
``layer_config``, with the published "DyConv" token: softmax(MLP(GAP(x)) / T)
over four expert kernels, the per-sample kernel mixed from them, then BN and
SiLU. Tokens:

  [out, k, s]           conv k x k stride s (padding 1 for 3x3) + BN + LeakyReLU
  ["B", n]              n residual pairs (1x1 to half, 3x3 back) with skips;
                        the output is a route when n == 8
  ["S"]                 one pair without skip, 1x1 to half, 3x3 back to the
                        width: a head's input
  ["U"]                 nearest 2x upsample, concatenated with the last route
  ["DyConv", out, k, s] the dynamic conv

Frames come in as (B, H, W, 3) floats in [0, 1].
"""

import torch
import torch.nn.functional as F
from torch import nn

from .common import ConvBN, Head, batch_norm, matmul, per_sample_conv, q


class DyConv(nn.Module):
    def __init__(self, c_in, c_out, k, stride, padding, experts=4):
        super().__init__()
        hidden = experts if c_in == 3 else int(c_in * 0.25) + 1
        self.attention = nn.Sequential(
            nn.Identity(), nn.Conv2d(c_in, hidden, 1, bias=False),
            nn.Identity(), nn.Conv2d(hidden, experts, 1))
        self.weights = nn.Parameter(torch.empty(experts, c_out, c_in, k, k))
        self.bn = nn.BatchNorm2d(c_out)
        self.stride, self.padding = stride, padding

    def forward(self, x, temperature, quant=None):
        fc1, fc2 = self.attention[1], self.attention[3]
        pooled = x.mean(dim=(2, 3))
        a = F.relu(matmul(pooled, fc1.weight.flatten(1).t(), quant))
        a = matmul(a, fc2.weight.flatten(1).t(), quant) + fc2.bias
        attn = torch.softmax(a / temperature, dim=-1)            # (B, E)
        kernels = torch.einsum("eoikl,be->boikl", self.weights, attn)
        if kernels.shape[-1] == 1 and self.stride == 1:
            b, c, h, w = x.shape
            rows = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
            y = matmul(rows, kernels[..., 0, 0].transpose(1, 2), quant)
            y = y.reshape(b, h, w, -1).permute(0, 3, 1, 2)
        else:
            y = per_sample_conv(x, kernels, None, self.stride, self.padding,
                                quant)
        return F.silu(batch_norm(y, self.bn))


class Residual(nn.Module):
    def __init__(self, c, use_residual=True, repeats=1):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.Sequential(ConvBN(c, c // 2, 1), ConvBN(c // 2, c, 3, 1, 1))
            for _ in range(repeats))
        self.use_residual = use_residual

    def weight_spec(self) -> dict:
        """The draw for ``weights.seeded_state`` of the scale of each
        branch's last BatchNorm, where the branch adds to its skip:
        U(0.1, 0.3), so that the sum stays near the skip through the deep
        stack."""
        if not self.use_residual:
            return {}
        return {f"layers.{r}.1.bn.weight": ("uniform", 0.1, 0.3)
                for r in range(len(self.layers))}

    def forward(self, x, quant=None):
        for pair in self.layers:
            y = pair[1](pair[0](x, quant), quant)
            x = y + x if self.use_residual else y
        return x


class Scale(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = ConvBN(c, 2 * c, 3, 1, 1)

    def forward(self, x, quant=None):
        return self.conv(x, quant)


class DyYOLO(nn.Module):
    def __init__(self, hparams):
        super().__init__()
        self.tokens = [tuple(t) for t in hparams["layer_config"]]
        self.temperature = float(hparams["attn_temperature"])
        self.layers = nn.ModuleList()
        c, head_c = 3, []
        for tok in self.tokens:
            if tok[0] == "B":
                self.layers.append(Residual(c, True, tok[1]))
            elif tok[0] == "S":
                self.layers.extend([Residual(c, False, 1),
                                    ConvBN(c, c // 2, 1), Scale(c // 2)])
                head_c.append(c)
                c //= 2
            elif tok[0] == "U":
                self.layers.append(nn.Identity())
                c *= 3
            elif tok[0] == "DyConv":
                o, k, s = tok[1:]
                self.layers.append(DyConv(c, o, k, s, 1 if k == 3 else 0))
                c = o
            else:
                o, k, s = tok
                self.layers.append(ConvBN(c, o, k, s, 1 if k == 3 else 0))
                c = o
        self.yolo_head = Head(head_c, len(hparams["anchors"][0]))

    def forward(self, x, quant=None):
        """x (B, H, W, 3) frames in [0, 1] -> per head (bbox, obj)
        logits."""
        x = q(x.to(self.yolo_head.detection_head[0]["obj"]["conv_obj"].weight.dtype).permute(0, 3, 1, 2), quant)
        routes, taps, i = [], [], 0
        for tok in self.tokens:
            if tok[0] == "B":
                x = self.layers[i](x, quant)
                if tok[1] == 8:
                    routes.append(x)
                i += 1
            elif tok[0] == "S":
                x = self.layers[i + 1](self.layers[i](x, quant), quant)
                taps.append(self.layers[i + 2](x, quant))
                i += 3
            elif tok[0] == "U":
                x = torch.cat([F.interpolate(x, scale_factor=2,
                                             mode="nearest"), routes.pop()],
                              dim=1)
                i += 1
            elif tok[0] == "DyConv":
                x = self.layers[i](x, self.temperature, quant)
                i += 1
            else:
                x = self.layers[i](x, quant)
                i += 1
        return self.yolo_head(taps, quant)


def build(hparams) -> nn.Module:
    return DyYOLO(hparams)
