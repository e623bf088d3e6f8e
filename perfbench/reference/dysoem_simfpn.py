"""DySOEM_SimFPN in plain PyTorch, float32: the reference of the benchmark's
``dysoem_simfpn`` configuration.

  input stem   1x1 conv 3 -> 32 + BN + SiLU
  3 x SOEM     space-to-depth by 2 (C -> 4C), attention softmax(MLP(GAP) / T)
               over E expert 3x3 convs 4C -> 2C with biases, the per-sample
               kernel and bias mixed from them, then BN + SiLU
  neck         the simplified FPN: x2 -> 1x1 -> up2 into the centre
               (x1 + up + x1), the centre -> 1x1 -> up2 into x0, x0 -> 1x1
               stride 2 into x1, x1 -> 1x1 stride 2 into x2, then a 3x3
               conv + BN + SiLU on each
  heads        1x1 objectness and box convs on the three maps, the highest
               resolution first

Frames come in as (B, H, W, 3) floats in [0, 1].
"""

import torch
import torch.nn.functional as F
from torch import nn

from .common import ConvBN, Head, batch_norm, conv, matmul, per_sample_conv, q


def space_to_depth(x: torch.Tensor, k: int = 2) -> torch.Tensor:
    """NCHW (B, C, H, W) -> (B, k*k*C, H/k, W/k): channel (pi*k + pj)*C + c
    holds pixel phase (pi, pj) of channel c."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // k, k, w // k, k).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, k * k * c, h // k, w // k)


class Experts(nn.Module):
    def __init__(self, ks, c_in, features):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(ks, ks, c_in, features))
        self.bias = nn.Parameter(torch.empty(features))


class SOEM(nn.Module):
    def __init__(self, c_in, experts=3, ks=3):
        super().__init__()
        c4 = 4 * c_in
        self.out_channels = c4 // 2
        self.attn_fc1 = nn.Linear(c4, max(1, c4 // 4))
        self.attn_fc2 = nn.Linear(max(1, c4 // 4), experts)
        self.experts = Experts(ks, c4, experts * self.out_channels)
        self.bn = nn.BatchNorm2d(self.out_channels)

    def forward(self, x, temperature, quant=None):
        f = space_to_depth(x)
        pooled = f.mean(dim=(2, 3))
        a = F.relu(matmul(pooled, self.attn_fc1.weight.t(), quant)
                   + self.attn_fc1.bias)
        a = matmul(a, self.attn_fc2.weight.t(), quant) + self.attn_fc2.bias
        attn = torch.softmax(a / temperature, dim=-1)            # (B, E)
        oc = self.out_channels
        ks, _, c, eco = self.experts.kernel.shape
        k = self.experts.kernel.reshape(ks, ks, c, eco // oc, oc)
        kernels = torch.einsum("hwceo,be->bochw", k, attn)
        bias = torch.einsum("eo,be->bo",
                            self.experts.bias.reshape(-1, oc), attn)
        y = per_sample_conv(f, kernels, bias, 1, ks // 2, quant)
        return F.silu(batch_norm(y, self.bn))


class SimplifiedFPN(nn.Module):
    def __init__(self, channels):
        super().__init__()
        c0, c1, c2 = channels
        self.x2_in_down = nn.Conv2d(c2, c1, 1)
        self.center_down = nn.Conv2d(c1, c0, 1)
        self.x0_out_up = nn.Conv2d(c0, c1, 1, stride=2)
        self.x1_out_up = nn.Conv2d(c1, c2, 1, stride=2)
        self.x0_conv_out = ConvBN(c0, c0, 3, 1, 1, act="silu")
        self.x1_conv_out = ConvBN(c1, c1, 3, 1, 1, act="silu")
        self.x2_conv_out = ConvBN(c2, c2, 3, 1, 1, act="silu")

    def forward(self, maps, quant=None):
        x0, x1, x2 = maps

        def c1x1(m, x):
            return conv(x, m.weight, m.bias, m.stride, 0, quant)

        def up2(x):
            return F.interpolate(x, scale_factor=2, mode="nearest")

        center = x1 + up2(c1x1(self.x2_in_down, x2)) + x1
        x0 = x0 + up2(c1x1(self.center_down, center))
        x1 = center + c1x1(self.x0_out_up, x0)
        x2 = x2 + c1x1(self.x1_out_up, x1)
        return (self.x0_conv_out(x0, quant), self.x1_conv_out(x1, quant),
                self.x2_conv_out(x2, quant))


class DySOEM_SimFPN(nn.Module):
    def __init__(self, hparams, stem_channels=32):
        super().__init__()
        self.temperature = float(hparams["attention_temperature"])
        self.input_stem = ConvBN(3, stem_channels, 1, act="silu")
        c, channels = stem_channels, []
        self.n_soem = len(hparams["num_dy_conv"])
        for i, (e, ks) in enumerate(zip(hparams["num_dy_conv"],
                                        hparams["dy_kernel_size"])):
            soem = SOEM(c, e, ks)
            self.add_module(f"soem_{i}", soem)
            c = soem.out_channels
            channels.append(c)
        self.neck = SimplifiedFPN(channels)
        self.yolo_head = Head(channels, len(hparams["anchors"][0]))

    def forward(self, x, quant=None):
        """x (B, H, W, 3) frames in [0, 1] -> per head (bbox, obj)
        logits."""
        x = q(x.float().permute(0, 3, 1, 2), quant)
        x = self.input_stem(x, quant)
        maps = []
        for i in range(self.n_soem):
            x = getattr(self, f"soem_{i}")(x, self.temperature, quant)
            maps.append(x)
        return self.yolo_head(self.neck(maps, quant), quant)


def build(hparams) -> nn.Module:
    return DySOEM_SimFPN(hparams)
