"""Seeded weights for a configuration, made on the device.

The distributions are those of a detector at initialisation with its
activations and scores in a trained detector's range. Every layer of these
classes gets its draws here:

  convs, linear layers and expert kernels   He-normal over the fan-in,
                                            biases 0
  BatchNorm                                 scale U(0.8, 1.2), shift and
                                            running mean N(0, 0.05), running
                                            variance U(0.8, 1.2)
  GroupNorm                                 scale U(0.8, 1.2), shift
                                            N(0, 0.05)

A module of a reference declares the draws of its own layers, and any that
differ from these, by a ``weight_spec()`` method: {state key relative to
the module: spec}, specs ``("normal", std)``, ``("uniform", lo, hi)`` or
``("const", v)``. Its entries override the rules above. So
``reference.common.Head`` draws its convs from N(0, 0.1) with the
objectness bias -log(99) (a prior of 0.01), and ``reference.dyyolo
.Residual`` the scale of each residual branch's last BatchNorm from
U(0.1, 0.3). A tensor of the state that no rule covers is a ``ValueError``.

All normal draws come from one ``torch.randn`` and all uniform draws from
one ``torch.rand`` of a generator on the device seeded with ``seed``; the
leaves are slices of them, in the order of the state dict. The same
dictionary is loaded into the program and into the reference.
"""

import math

import torch
from torch import nn

from .reference.common import he_std


def _specs(model: nn.Module) -> dict:
    """{state key: ("normal", std) | ("uniform", lo, hi) | ("const", v)}
    for every tensor of ``model``'s state but BatchNorm's step counts."""
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
        elif isinstance(m, nn.GroupNorm) and m.affine:
            spec[pre + "weight"] = ("uniform", 0.8, 1.2)
            spec[pre + "bias"] = ("normal", 0.05)
        for pname, p in m.named_parameters(recurse=False):
            if pname == "weights":          # DyConv experts (E, O, I, k, k)
                spec[pre + pname] = ("normal", he_std(p[0, 0].numel()))
            elif pname == "kernel":         # SOEM experts HWIO (k, k, I, EO)
                spec[pre + pname] = ("normal", he_std(p[..., 0].numel()))
            elif pname == "bias" and pre + pname not in spec:
                spec[pre + pname] = ("const", 0.0)
    state = model.state_dict()
    for name, m in model.named_modules():
        if not hasattr(m, "weight_spec"):
            continue
        pre = f"{name}." if name else ""
        for key, s in m.weight_spec().items():
            if pre + key not in state:
                raise ValueError(f"{type(m).__name__}.weight_spec names "
                                 f"{pre + key!r}, which is not in the state")
            spec[pre + key] = s
    for key in state:
        if key not in spec and not key.endswith("num_batches_tracked"):
            owner = model.get_submodule(key.rpartition(".")[0])
            raise ValueError(f"no draw for {key!r}, a tensor of "
                             f"{type(owner).__name__}: declare it in that "
                             "module's weight_spec()")
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
