"""The weight bridge from the JAX package's flax trees to the port.

``state_dict_from_flax`` is the exact inverse of
``uavdet_tpu/utils/torch_import.py:import_interpreter_state_dict``: it walks
the ``layer_config`` tokens in the order the reference builds its
``nn.ModuleList`` and writes the reference's state_dict keys.

  HWIO conv kernel (kh, kw, I, O)        -> OIHW (O, I, kh, kw)
  Dense kernel (I, O) of the attention   -> 1x1 conv (O, I, 1, 1)
  DyConv experts (k, k, I, E*O), e-major -> (E, O, I, k, k)
  BatchNorm scale/bias + mean/var        -> weight/bias + running_mean/var

Arrays stay numpy; nothing here imports JAX.
"""

from typing import Dict

import numpy as np
import torch


def _conv_w(w):
    return np.ascontiguousarray(np.transpose(np.asarray(w), (3, 2, 0, 1)))


def _dense_as_conv(w):
    return np.ascontiguousarray(np.transpose(np.asarray(w))[:, :, None, None])


def state_dict_from_flax(variables, layer_config) -> Dict[str, np.ndarray]:
    """Flax ``{"params": {"net": ...}, "batch_stats": {"net": ...}}`` of a
    DyYOLO/BaselineModel -> the reference state_dict, as numpy arrays."""
    params = variables["params"]["net"]
    stats = variables["batch_stats"]["net"]
    sd: Dict[str, np.ndarray] = {}
    counters: Dict[str, int] = {}

    def next_name(cls):
        n = counters.get(cls, 0)
        counters[cls] = n + 1
        return f"{cls}_{n}"

    def bn(prefix, p, s):
        sd[f"{prefix}.weight"] = np.asarray(p["scale"])
        sd[f"{prefix}.bias"] = np.asarray(p["bias"])
        sd[f"{prefix}.running_mean"] = np.asarray(s["mean"])
        sd[f"{prefix}.running_var"] = np.asarray(s["var"])
        sd[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)

    def cnnblock(prefix, p, s):
        sd[f"{prefix}.conv.weight"] = _conv_w(p["Conv_0"]["kernel"])
        if "bias" in p["Conv_0"]:
            sd[f"{prefix}.conv.bias"] = np.asarray(p["Conv_0"]["bias"])
        bn(f"{prefix}.bn", p["BatchNorm_0"], s["BatchNorm_0"])

    def resblock(ref_i, name, num_repeats):
        for r in range(num_repeats):
            for j in range(2):
                cb = f"CNNBlock_{2 * r + j}"
                cnnblock(f"layers.{ref_i}.layers.{r}.{j}", params[name][cb],
                         stats[name][cb])

    ref_i = 0
    for tok in layer_config:
        if tok[0] == "B":
            resblock(ref_i, next_name("ResidualBlock"), tok[1])
            ref_i += 1
        elif tok[0] == "S":
            resblock(ref_i, next_name("ResidualBlock"), 1)
            cb = next_name("CNNBlock")
            cnnblock(f"layers.{ref_i + 1}", params[cb], stats[cb])
            sp = next_name("ScalePrediction")
            cnnblock(f"layers.{ref_i + 2}.conv", params[sp]["CNNBlock_0"],
                     stats[sp]["CNNBlock_0"])
            ref_i += 3
        elif tok[0] == "U":
            ref_i += 1
        elif tok[0] == "DyConv":
            name = next_name("DyConvModule")
            p, s = params[name], stats[name]
            pre = f"layers.{ref_i}"
            sd[f"{pre}.attention.1.weight"] = _dense_as_conv(
                p["attn_fc1"]["kernel"])
            sd[f"{pre}.attention.3.weight"] = _dense_as_conv(
                p["attn_fc2"]["kernel"])
            sd[f"{pre}.attention.3.bias"] = np.asarray(p["attn_fc2"]["bias"])
            e = sd[f"{pre}.attention.3.bias"].shape[0]
            kh, kw, i, eo = np.shape(p["experts"])
            w = np.asarray(p["experts"]).reshape(kh, kw, i, e, eo // e)
            sd[f"{pre}.weights"] = np.ascontiguousarray(
                np.transpose(w, (3, 4, 2, 0, 1)))
            bn(f"{pre}.bn", p["BatchNorm_0"], s["BatchNorm_0"])
            ref_i += 1
        else:
            cb = next_name("CNNBlock")
            cnnblock(f"layers.{ref_i}", params[cb], stats[cb])
            ref_i += 1

    head = params["yolo_head"]
    h = 0
    while f"obj_{h}" in head:
        pre = f"yolo_head.detection_head.{h}"
        for kind in ("obj", "bbox"):
            conv = head[f"{kind}_{h}"]["Conv_0"]
            sd[f"{pre}.{kind}.conv_{kind}.weight"] = _conv_w(conv["kernel"])
            sd[f"{pre}.{kind}.conv_{kind}.bias"] = np.asarray(conv["bias"])
        h += 1
    return sd


def load_flax_variables(model: torch.nn.Module, variables) -> None:
    """Load a flax variables tree into the port's model (strict)."""
    sd = state_dict_from_flax(variables, model.tokens)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()}, strict=True)
