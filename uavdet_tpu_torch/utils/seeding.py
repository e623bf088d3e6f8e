"""Seeded random weights for a model of the port.

The weights are drawn on the CPU from one explicit ``torch.Generator`` and
then moved, so one seed gives the same weights on every device. Convs and
the dynamic-conv experts are He-normal (fan-in), biases zero, and the
BatchNorm affine and running statistics are perturbed around identity so
that inference-mode BN does real work; the scale ends of residual branches
and the heads are drawn small so that activations and scores stay in the
range of a trained detector.
"""

import math

import torch
from torch import nn

from ..models.dysoem_simfpn import Experts
from ..models.layers import DyConvModule, ResidualBlock
from ..models.registry import build_model, serving_dtype


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> nn.Module:
    g = torch.Generator().manual_seed(seed)

    def normal(t, std):
        t.copy_(torch.randn(t.shape, generator=g) * std)

    def uniform(t, lo, hi):
        t.copy_(lo + (hi - lo) * torch.rand(t.shape, generator=g))

    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            normal(m.weight, math.sqrt(2.0 / fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            uniform(m.weight, 0.8, 1.2)
            normal(m.bias, 0.05)
            normal(m.running_mean, 0.05)
            uniform(m.running_var, 0.8, 1.2)
        elif isinstance(m, DyConvModule):
            normal(m.weights, math.sqrt(2.0 / m.weights[0, 0].numel()))
        elif isinstance(m, Experts):   # HWIO: fan-in is all but the last axis
            normal(m.kernel, math.sqrt(2.0 / m.kernel[..., 0].numel()))
            m.bias.zero_()
        elif isinstance(m, nn.Linear):
            normal(m.weight, math.sqrt(2.0 / m.weight.shape[1]))
            m.bias.zero_()
    # residual branches end in a small BN scale, so 8 repeats of He-normal
    # branches do not multiply the activations' scale (by ~35x each stage)
    for m in model.modules():
        if isinstance(m, ResidualBlock) and m.use_residual:
            for branch in m.layers:
                uniform(branch[1].bn.weight, 0.1, 0.3)
    # heads: small weights and an objectness prior of 0.01, the usual YOLO
    # start, so scores spread below 1 instead of saturating
    for head in model.yolo_head.detection_head:
        normal(head["obj"]["conv_obj"].weight, 0.1)
        head["obj"]["conv_obj"].bias.fill_(-math.log(99.0))
        normal(head["bbox"]["conv_bbox"].weight, 0.1)
    return model


def seeded_model(name: str, hparams, seed: int, device="cuda",
                 dtype: torch.dtype | None = None) -> nn.Module:
    """``build_model`` with seeded weights, in eval mode, on ``device``: the
    card unless the caller names another (without a card the default raises
    PyTorch's own error). ``dtype`` None is ``serving_dtype`` of the device:
    bf16 on the card, float32 elsewhere.

    On a CUDA device the model is channels_last, the layout cuDNN prefers
    and the one the kernels' NHWC outputs already have.
    """
    model = init_weights(build_model(name, hparams, device="cpu"),
                         seed).eval()
    model.to(device=device,
             dtype=serving_dtype(device) if dtype is None else dtype)
    if torch.device(device).type == "cuda":
        for m in model.modules():   # the 5-D expert tensors keep their layout
            if isinstance(m, nn.Conv2d):
                m.to(memory_format=torch.channels_last)
    return model
