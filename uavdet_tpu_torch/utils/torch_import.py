"""The reference's Lightning checkpoints in the port: its own copy of
``uavdet_tpu/utils/torch_import.py``.

The port's DyYOLO and BaselineModel carry the reference's state_dict keys
(``utils/weights.py``), so a reference state_dict loads as it is, with no
layout transform. What is left is to unwrap Lightning's ``state_dict``, make
tensors of its values, and check the structure against a freshly built
model: a key missing, a key the model lacks, or a shape that differs
raises, naming the keys (the counterpart of
``scripts/port_reference_checkpoint.py:41-53`` in the JAX package).
"""

from typing import Dict, Mapping

import numpy as np
import torch

from ..models.interpreter import YOLOInterpreter

_SHOWN = 20   # keys named per kind of mismatch


def import_interpreter_state_dict(state_dict: Mapping, layer_config,
                                  n_anchors: int = 3
                                  ) -> Dict[str, torch.Tensor]:
    """A reference BaselineModel / DyYOLO state_dict (tensors or arrays) ->
    the port's state_dict for the interpreter of ``layer_config``, checked
    key by key and shape by shape against a model built on the meta device
    (no memory, no initialization)."""
    sd = {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(
        np.asarray(v)) for k, v in state_dict.items()}
    with torch.device("meta"):
        ref = YOLOInterpreter(layer_config, n_anchors).state_dict()
    missing = sorted(set(ref) - set(sd))
    unexpected = sorted(set(sd) - set(ref))
    shapes = sorted(f"{k} {tuple(sd[k].shape)} != {tuple(ref[k].shape)}"
                    for k in set(sd) & set(ref)
                    if sd[k].shape != ref[k].shape)
    problems = [f"{what} ({len(keys)}): {keys[:_SHOWN]}"
                for what, keys in (("missing", missing),
                                   ("unexpected", unexpected),
                                   ("shape", shapes)) if keys]
    if problems:
        raise ValueError("the state_dict does not fit the layer_config: "
                         + "; ".join(problems))
    return sd


def load_lightning_checkpoint(path: str, layer_config,
                              n_anchors: int = 3) -> Dict[str, torch.Tensor]:
    """Load a reference ``.ckpt`` (a Lightning checkpoint, or a bare
    state_dict) and import it. The file is unpickled whole (Lightning keeps
    its hyper-parameters as objects), so load only checkpoints you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return import_interpreter_state_dict(ckpt.get("state_dict", ckpt),
                                         layer_config, n_anchors)
