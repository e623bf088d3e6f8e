"""The ``layer_config`` interpreter: ``uavdet_tpu/models/interpreter.py``.

Token semantics (reference model/DyYOLO.py:63-112):

  [out_c, k, s]           -> CNNBlock(out_c, k, s, padding 1 if k == 3 else 0)
  ["B", n]                -> ResidualBlock x n repeats; pushed on the route
                             stack when n == 8
  ["S"]                   -> ResidualBlock (no skip) + 1x1 CNNBlock(half) +
                             ScalePrediction, whose output feeds a head
  ["U"]                   -> nearest 2x upsample + concat with the route popped
  ["DyConv", out_c, k, s] -> DyConvModule

The modules live in one ``layers`` ModuleList in the reference's order, so
the state_dict keys are the reference's (``layers.{i}...``).
"""

from typing import Sequence

import torch
from torch import nn

from .layers import (CNNBlock, DyConvModule, ResidualBlock, ScalePrediction,
                     YOLOHead)


class YOLOInterpreter(nn.Module):
    """Backbone + FPN built from ``layer_config``, ending in a YOLOHead."""

    def __init__(self, layer_config: Sequence, n_anchors: int = 3,
                 attn_temperature: float = 30.0, in_channels: int = 3):
        super().__init__()
        self.tokens = tuple(tuple(t) for t in layer_config)
        self.attn_temperature = float(attn_temperature)
        self.layers = nn.ModuleList()
        self.first_layer = []   # index in ``layers`` of each token's module
        c = in_channels
        head_c = []
        for tok in self.tokens:
            self.first_layer.append(len(self.layers))
            if tok[0] == "B":
                self.layers.append(ResidualBlock(c, num_repeats=tok[1]))
            elif tok[0] == "S":
                self.layers.extend([
                    ResidualBlock(c, use_residual=False, num_repeats=1),
                    CNNBlock(c, c // 2, kernel_size=1),
                    ScalePrediction(c // 2)])
                head_c.append(c)
                c //= 2
            elif tok[0] == "U":
                # nearest-neighbour, as the reference's nn.Upsample(2)
                self.layers.append(nn.Upsample(scale_factor=2))
                c *= 3
            elif tok[0] == "DyConv":
                o, k, s = tok[1:]
                self.layers.append(DyConvModule(c, o, k, s,
                                                1 if k == 3 else 0))
                c = o
            else:
                o, k, s = tok
                self.layers.append(CNNBlock(c, o, k, s, 1 if k == 3 else 0))
                c = o
        self.yolo_head = YOLOHead(head_c, n_anchors)

    @property
    def dtype(self) -> torch.dtype:
        return next(self.parameters()).dtype

    def forward(self, x: torch.Tensor, start: int = 0):
        """x: (B, H, W, C) NHWC, the frames (``start`` 0) or the activation
        entering token ``start``. -> one DetectionResults per head."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)   # NCHW view of NHWC memory
        taps = []
        run_tokens(self.layers, self.tokens[start:], self.first_layer[start:],
                   x, [], taps, self.attn_temperature)
        return self.yolo_head(taps)


def run_tokens(layers, tokens, first_layer, x: torch.Tensor, routes: list,
               taps: list, attn_temperature: float) -> torch.Tensor:
    """Apply ``tokens`` to the NCHW activation ``x``: token j runs the
    module ``layers[first_layer[j]]`` (an "S" token the two after it too).
    ``routes`` (the route stack) and ``taps`` (the heads' inputs) are lists
    that the tokens push to and pop from in place. -> the activation."""
    for tok, i in zip(tokens, first_layer):
        kind = tok[0]
        if kind == "B":
            x = layers[i](x)
            if tok[1] == 8:
                routes.append(x)
        elif kind == "S":
            x = layers[i + 1](layers[i](x))
            taps.append(layers[i + 2](x))
        elif kind == "U":
            x = torch.cat([layers[i](x), routes.pop()], dim=1)
        elif kind == "DyConv":
            x = layers[i](x, attn_temperature)
        else:
            x = layers[i](x)
    return x
