"""The weight bridge from the JAX package's flax trees to the port.

``state_dict_from_flax`` is the exact inverse of
``uavdet_tpu/utils/torch_import.py:import_interpreter_state_dict``: it walks
the ``layer_config`` tokens in the order the reference builds its
``nn.ModuleList`` and writes the reference's state_dict keys.

  HWIO conv kernel (kh, kw, I, O)        -> OIHW (O, I, kh, kw)
  Dense kernel (I, O) of the attention   -> 1x1 conv (O, I, 1, 1)
  DyConv experts (k, k, I, E*O), e-major -> (E, O, I, k, k)
  BatchNorm scale/bias + mean/var        -> weight/bias + running_mean/var

``dysoem_state_dict_from_flax`` does the same for a DySOEM_SimFPN tree, onto
the names of ``models/dysoem_simfpn.py`` (there is no reference checkpoint
map for that model yet):

  Dense kernel (I, O) + bias             -> nn.Linear weight (O, I) + bias
  SOEM experts kernel (3, 3, 4C, E*Co) and bias (E*Co,), expert-major
                                         -> kept as they are, one tensor each
  HWIO conv kernels of stem, neck, head  -> OIHW

``rtm_state_dict_from_flax`` maps an RTMUAVDet tree, or the tree of one of
its blocks, onto the names of ``models/rtm_uav_det.py``, which are the flax
scopes' (``stem``, ``MDyCSP_1``, ``mdy_conv``, ``neck``, ``head/obj_0``...)
but for ``RTMConvModule_0`` inside an MDyConv, which is ``base``:

  Conv_0 + BatchNorm_0 of an RTMConvModule -> conv + bn
  Dense kernel (I, O) + bias               -> nn.Linear weight (O, I) + bias
  GroupNorm scale + bias                   -> weight + bias
  HWIO conv kernel + bias (neck, head)     -> OIHW weight + bias

Arrays stay numpy; nothing here imports JAX.
"""

from typing import Dict

import numpy as np
import torch


def _conv_w(w):
    return np.ascontiguousarray(np.transpose(np.asarray(w), (3, 2, 0, 1)))


def _dense_as_conv(w):
    return np.ascontiguousarray(np.transpose(np.asarray(w))[:, :, None, None])


def _bn(sd, prefix, p, s):
    sd[f"{prefix}.weight"] = np.asarray(p["scale"])
    sd[f"{prefix}.bias"] = np.asarray(p["bias"])
    sd[f"{prefix}.running_mean"] = np.asarray(s["mean"])
    sd[f"{prefix}.running_var"] = np.asarray(s["var"])
    sd[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)


def _head(sd, head):
    h = 0
    while f"obj_{h}" in head:
        pre = f"yolo_head.detection_head.{h}"
        for kind in ("obj", "bbox"):
            conv = head[f"{kind}_{h}"]["Conv_0"]
            sd[f"{pre}.{kind}.conv_{kind}.weight"] = _conv_w(conv["kernel"])
            sd[f"{pre}.{kind}.conv_{kind}.bias"] = np.asarray(conv["bias"])
        h += 1


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

    def cnnblock(prefix, p, s):
        sd[f"{prefix}.conv.weight"] = _conv_w(p["Conv_0"]["kernel"])
        if "bias" in p["Conv_0"]:
            sd[f"{prefix}.conv.bias"] = np.asarray(p["Conv_0"]["bias"])
        _bn(sd, f"{prefix}.bn", p["BatchNorm_0"], s["BatchNorm_0"])

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
            _bn(sd, f"{pre}.bn", p["BatchNorm_0"], s["BatchNorm_0"])
            ref_i += 1
        else:
            cb = next_name("CNNBlock")
            cnnblock(f"layers.{ref_i}", params[cb], stats[cb])
            ref_i += 1

    _head(sd, params["yolo_head"])
    return sd


def dysoem_state_dict_from_flax(variables) -> Dict[str, np.ndarray]:
    """Flax ``{"params": ..., "batch_stats": ...}`` of a DySOEM_SimFPN -> the
    state_dict of the port's ``DySOEM_SimFPN``, as numpy arrays."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, np.ndarray] = {}

    def conv_module(prefix, p, s):
        sd[f"{prefix}.conv.weight"] = _conv_w(p["Conv_0"]["kernel"])
        _bn(sd, f"{prefix}.bn", p["BatchNorm_0"], s["BatchNorm_0"])

    conv_module("input_stem", params["input_stem"]["ConvModule_0"],
                stats["input_stem"]["ConvModule_0"])
    i = 0
    while f"soem_{i}" in params:
        p, pre = params[f"soem_{i}"], f"soem_{i}"
        for fc in ("attn_fc1", "attn_fc2"):
            sd[f"{pre}.{fc}.weight"] = np.ascontiguousarray(
                np.transpose(np.asarray(p[fc]["kernel"])))
            sd[f"{pre}.{fc}.bias"] = np.asarray(p[fc]["bias"])
        sd[f"{pre}.experts.kernel"] = np.asarray(p["experts"]["kernel"])
        sd[f"{pre}.experts.bias"] = np.asarray(p["experts"]["bias"])
        _bn(sd, f"{pre}.bn", p["BatchNorm_0"],
            stats[f"soem_{i}"]["BatchNorm_0"])
        i += 1
    for name, p in params["neck"].items():
        if "Conv_0" in p:
            conv_module(f"neck.{name}", p, stats["neck"][name])
        else:
            sd[f"neck.{name}.weight"] = _conv_w(p["kernel"])
            sd[f"neck.{name}.bias"] = np.asarray(p["bias"])
    _head(sd, params["yolo_head"])
    return sd


_RTM_CONV_MODULES = ("stem", "base_conv", "conv1", "conv2", "transition1",
                     "transition2")


def rtm_state_dict_from_flax(variables, block: str = "RTMUAVDet"
                             ) -> Dict[str, np.ndarray]:
    """Flax ``{"params": ..., "batch_stats": ...}`` of an RTMUAVDet, or of
    one of its blocks named by ``block`` (``"MDyConv"``, ``"MDyCSPModule"``,
    ``"MDyEncoder"``, ``"MFDFEncoderModule"``, ``"RTMHead"``) -> the state
    dict of the port's module of that class, as numpy arrays. Without
    ``batch_stats`` (a tree of the parameters' shape, such as Adam's
    moments) the running statistics are left out.
    """
    sd: Dict[str, np.ndarray] = {}

    def conv_module(prefix, p, s):
        if "RTMConvModule_0" in p:   # StemLayer wraps one
            p, s = p["RTMConvModule_0"], s.get("RTMConvModule_0", {})
        sd[f"{prefix}conv.weight"] = _conv_w(p["Conv_0"]["kernel"])
        if "BatchNorm_0" in s:
            _bn(sd, f"{prefix}bn", p["BatchNorm_0"], s["BatchNorm_0"])
        else:
            sd[f"{prefix}bn.weight"] = np.asarray(p["BatchNorm_0"]["scale"])
            sd[f"{prefix}bn.bias"] = np.asarray(p["BatchNorm_0"]["bias"])

    def conv(prefix, p):
        sd[f"{prefix}weight"] = _conv_w(p["kernel"])
        sd[f"{prefix}bias"] = np.asarray(p["bias"])

    def linear(prefix, p):
        sd[f"{prefix}weight"] = np.ascontiguousarray(
            np.transpose(np.asarray(p["kernel"])))
        sd[f"{prefix}bias"] = np.asarray(p["bias"])

    def mdyconv(prefix, p, s):
        conv_module(f"{prefix}base.", p["RTMConvModule_0"],
                    s.get("RTMConvModule_0", {}))
        for fc in ("attention", "channel_fc", "kernel_fc"):
            linear(f"{prefix}{fc}.", p[fc])

    def csp(prefix, p, s):
        for name in _RTM_CONV_MODULES[1:]:
            conv_module(f"{prefix}{name}.", p[name], s.get(name, {}))
        mdyconv(f"{prefix}mdy_conv.", p["mdy_conv"],
                s.get("mdy_conv", {}))

    def encoder(prefix, p, s):
        for name in ("group_norm_in", "group_norm_out"):
            sd[f"{prefix}{name}.weight"] = np.asarray(p[name]["scale"])
            sd[f"{prefix}{name}.bias"] = np.asarray(p[name]["bias"])
        for k in (1, 3, 5):
            name = f"mdy_conv_{k}x{k}"
            mdyconv(f"{prefix}{name}.", p[name], s.get(name, {}))
        conv(f"{prefix}mlp_fc1.", p["mlp_fc1"])
        conv(f"{prefix}mlp_fc2.", p["mlp_fc2"])

    def mfdf(prefix, p, s):
        conv(f"{prefix}upsample_conv.", p["upsample_conv"])
        conv(f"{prefix}downsample.", p["downsample"])
        for name in ("encoder_x1", "encoder_x2"):
            encoder(f"{prefix}{name}.", p[name], s.get(name, {}))

    def head(prefix, p, s):
        for name, q in p.items():
            conv(f"{prefix}{name}.", q)

    def model(prefix, p, s):
        conv_module(f"{prefix}stem.", p["stem"], s.get("stem", {}))
        csp(f"{prefix}MDyCSP_1.", p["MDyCSP_1"], s.get("MDyCSP_1", {}))
        csp(f"{prefix}MDyCSP_2.", p["MDyCSP_2"], s.get("MDyCSP_2", {}))
        mfdf(f"{prefix}neck.", p["neck"], s.get("neck", {}))
        head(f"{prefix}head.", p["head"], {})

    fns = {"MDyConv": mdyconv, "MDyCSPModule": csp, "MDyEncoder": encoder,
           "MFDFEncoderModule": mfdf, "RTMHead": head, "RTMUAVDet": model}
    if block not in fns:
        raise ValueError(f"unknown RTMUAVDet block {block!r}")
    fns[block]("", variables["params"], variables.get("batch_stats", {}))
    return sd


def load_flax_variables(model: torch.nn.Module, variables) -> None:
    """Load a flax variables tree into the port's model (strict): a
    DyYOLO-style interpreter, a DySOEM_SimFPN, or an RTMUAVDet or one of
    its blocks."""
    from ..models import rtm_uav_det
    if hasattr(model, "tokens"):
        sd = state_dict_from_flax(variables, model.tokens)
    elif type(model).__module__ == rtm_uav_det.__name__:
        sd = rtm_state_dict_from_flax(variables, type(model).__name__)
    else:
        sd = dysoem_state_dict_from_flax(variables)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()}, strict=True)
