"""The system under test: with ``entries/``, the only modules of the
benchmark that import the PyTorch and CUDA package, ``uavdet_tpu_torch``,
and only its public entry points (``models.build_model``, the entries'
builders, ``kernels.launch_counts``)."""

from types import SimpleNamespace

import torch
from torch import nn


def _namespace(value):
    if isinstance(value, dict):
        return SimpleNamespace(**{k: _namespace(v) for k, v in value.items()})
    if isinstance(value, list):
        return tuple(_namespace(v) for v in value)
    return value


def hparams(config: dict):
    """The configuration's ``hparams`` as the nested namespace of tuples
    that the program's builders read."""
    return _namespace(config["hparams"])


def build(config: dict, state: dict, dtype: torch.dtype, device) -> nn.Module:
    """``models.build_model`` of the configuration on ``device`` in
    ``dtype``, holding ``state``, with its convolutions channels_last on a
    CUDA device (the layout the program's own seeded models take there)."""
    from uavdet_tpu_torch.models import build_model
    model = build_model(config["model"], hparams(config), dtype=dtype,
                        device=device)
    model.load_state_dict(state)
    model.eval()
    if torch.device(device).type == "cuda":
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                m.to(memory_format=torch.channels_last)
    return model


def launch_counts() -> dict:
    from uavdet_tpu_torch import kernels
    return kernels.launch_counts()
