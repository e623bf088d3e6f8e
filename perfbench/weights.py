"""Seeded weights for a configuration, made on the device.

The distributions are those of a detector at initialisation with its
activations and scores in a trained detector's range:

  convs, linear layers and expert kernels   He-normal over the fan-in,
                                            biases 0
  BatchNorm                                 scale U(0.8, 1.2), shift and
                                            running mean N(0, 0.05), running
                                            variance U(0.8, 1.2)
  the last BatchNorm of a residual branch   scale U(0.1, 0.3)
  head convs                                N(0, 0.1), objectness bias
                                            -log(99) (a prior of 0.01)

All normal draws come from one ``torch.randn`` and all uniform draws from
one ``torch.rand`` of a generator on the device seeded with ``seed``; the
leaves are slices of them. The same dictionary is loaded into the program
and into the reference.
"""

import math

import torch
from torch import nn

from .reference.common import Head, he_std


def _specs(model: nn.Module) -> dict:
    """{state key: ("normal", std) | ("uniform", lo, hi) | ("const", v)}
    for every floating tensor of ``model``'s state."""
    spec = {}
    for name, m in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(m, nn.Conv2d):
            spec[pre + "weight"] = ("normal", he_std(m.weight[0].numel()))
            if m.bias is not None:
                spec[pre + "bias"] = ("const", 0.0)
        elif isinstance(m, nn.Linear):
            spec[pre + "weight"] = ("normal", he_std(m.weight.shape[1]))
            spec[pre + "bias"] = ("const", 0.0)
        elif isinstance(m, nn.BatchNorm2d):
            spec[pre + "weight"] = ("uniform", 0.8, 1.2)
            spec[pre + "bias"] = ("normal", 0.05)
            spec[pre + "running_mean"] = ("normal", 0.05)
            spec[pre + "running_var"] = ("uniform", 0.8, 1.2)
        for pname, p in m.named_parameters(recurse=False):
            if pname == "weights":          # DyConv experts (E, O, I, k, k)
                spec[pre + pname] = ("normal", he_std(p[0, 0].numel()))
            elif pname == "kernel":         # SOEM experts HWIO (k, k, I, EO)
                spec[pre + pname] = ("normal", he_std(p[..., 0].numel()))
            elif pname == "bias" and pre + pname not in spec:
                spec[pre + pname] = ("const", 0.0)
    for name, m in model.named_modules():
        pre = f"{name}." if name else ""
        if getattr(m, "use_residual", False):
            for r in range(len(m.layers)):
                spec[f"{pre}layers.{r}.1.bn.weight"] = ("uniform", 0.1, 0.3)
        if isinstance(m, Head):
            for h in range(len(m.detection_head)):
                obj = f"{pre}detection_head.{h}.obj.conv_obj."
                box = f"{pre}detection_head.{h}.bbox.conv_bbox."
                spec[obj + "weight"] = ("normal", 0.1)
                spec[obj + "bias"] = ("const", -math.log(99.0))
                spec[box + "weight"] = ("normal", 0.1)
    return spec


@torch.no_grad()
def seeded_state(model: nn.Module, seed: int, device,
                 dtype: torch.dtype = torch.float32) -> dict:
    """The state dict of ``model`` (a reference module, on any device, the
    ``meta`` one included) drawn from ``seed`` on ``device``, rounded to
    ``dtype`` (the dtype the configuration serves in) and held in
    float32."""
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    spec = _specs(model)
    n_normal = sum(math.prod(shapes[k]) for k, s in spec.items()
                   if s[0] == "normal")
    n_uniform = sum(math.prod(shapes[k]) for k, s in spec.items()
                    if s[0] == "uniform")
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device)
    state, i_n, i_u = {}, 0, 0
    for key, shape in shapes.items():
        if key.endswith("num_batches_tracked"):
            state[key] = torch.zeros((), dtype=torch.long, device=device)
            continue
        s, n = spec[key], math.prod(shape)
        if s[0] == "normal":
            t = normal[i_n:i_n + n] * s[1]
            i_n += n
        elif s[0] == "uniform":
            t = s[1] + (s[2] - s[1]) * uniform[i_u:i_u + n]
            i_u += n
        else:
            t = torch.full((n,), s[1], device=device)
        state[key] = t.reshape(shape).to(dtype).float()
    return state
