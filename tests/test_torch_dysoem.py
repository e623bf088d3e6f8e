"""The port's DySOEM_SimFPN (uavdet_tpu_torch/models/dysoem_simfpn.py), its
weight bridge and its detector against the JAX package, on the CPU.

Both sides get the same weights: the port's seeded random weights (random
BatchNorm statistics included), written into a flax variables tree by
``flax_from_port`` below and, for the tests of the bridge, read back by
``dysoem_state_dict_from_flax``. The model is full width
(conf/model/dy-soem_fpn.yaml) on small frames. Where the JAX side reaches
the Pallas dyconv kernel it runs in interpret mode.
"""

import inspect
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tests.test_torch_detector import _assert_same_detections
from uavdet_tpu.inference import make_detector as jax_make_detector
from uavdet_tpu.models import dysoem_simfpn as jax_dysoem
from uavdet_tpu.ops.fold_soem_neck import fold_soem_neck_forward
from uavdet_tpu_torch import kernels
from uavdet_tpu_torch.inference import make_detector, preprocess
from uavdet_tpu_torch.models import DYSOEM, DySOEM_SimFPN, build_model
from uavdet_tpu_torch.models.registry import serving_dtype
from uavdet_tpu_torch.models.dysoem_simfpn import DynamicSOEM, space_to_depth
from uavdet_tpu_torch.ops.dyconv import parity_sums
from uavdet_tpu_torch.utils.seeding import init_weights, seeded_model
from uavdet_tpu_torch.utils.weights import (dysoem_state_dict_from_flax,
                                            load_flax_variables)


def _hwio(w):
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def flax_from_port(sd):
    """The flax variables tree of the JAX DySOEM_SimFPN holding the port's
    state_dict ``sd`` (numpy arrays): the inverse of the bridge, written
    out by hand."""
    def bn(pre):
        return ({"scale": sd[f"{pre}.weight"], "bias": sd[f"{pre}.bias"]},
                {"mean": sd[f"{pre}.running_mean"],
                 "var": sd[f"{pre}.running_var"]})

    def conv_module(pre):
        p, s = bn(f"{pre}.bn")
        return ({"Conv_0": {"kernel": _hwio(sd[f"{pre}.conv.weight"])},
                 "BatchNorm_0": p}, {"BatchNorm_0": s})

    params, stats = {}, {}
    p, s = conv_module("input_stem")
    params["input_stem"] = {"ConvModule_0": p}
    stats["input_stem"] = {"ConvModule_0": s}
    for i in range(3):
        pre = f"soem_{i}"
        p, s = bn(f"{pre}.bn")
        params[pre] = {
            "attn_fc1": {"kernel": sd[f"{pre}.attn_fc1.weight"].T.copy(),
                         "bias": sd[f"{pre}.attn_fc1.bias"]},
            "attn_fc2": {"kernel": sd[f"{pre}.attn_fc2.weight"].T.copy(),
                         "bias": sd[f"{pre}.attn_fc2.bias"]},
            "experts": {"kernel": sd[f"{pre}.experts.kernel"],
                        "bias": sd[f"{pre}.experts.bias"]},
            "BatchNorm_0": p}
        stats[pre] = {"BatchNorm_0": s}
    params["neck"], stats["neck"] = {}, {}
    for name in ("x2_in_down", "center_down", "x0_out_up", "x1_out_up"):
        params["neck"][name] = {"kernel": _hwio(sd[f"neck.{name}.weight"]),
                                "bias": sd[f"neck.{name}.bias"]}
    for name in ("x0_conv_out", "x1_conv_out", "x2_conv_out"):
        params["neck"][name], stats["neck"][name] = conv_module(
            f"neck.{name}")
    params["yolo_head"] = {}
    for h in range(3):
        for kind in ("obj", "bbox"):
            pre = f"yolo_head.detection_head.{h}.{kind}.conv_{kind}"
            params["yolo_head"][f"{kind}_{h}"] = {"Conv_0": {
                "kernel": _hwio(sd[f"{pre}.weight"]),
                "bias": sd[f"{pre}.bias"]}}
    return {"params": params, "batch_stats": stats}


def _models(seed, bf16_weights=False):
    """(flax variables, the port's f32 model) with the same weights;
    ``bf16_weights`` rounds them to bf16 values first, so that a bf16 copy of
    the port and flax's f32 masters hold the same numbers."""
    port = init_weights(DySOEM_SimFPN(), seed).eval()
    if bf16_weights:
        sd = {k: (v.to(torch.bfloat16).float() if v.is_floating_point()
                  else v) for k, v in port.state_dict().items()}
        port.load_state_dict(sd)
    v = flax_from_port({k: t.numpy() for k, t in port.state_dict().items()})
    return v, port


@pytest.fixture(scope="module")
def f32_models():
    return _models(3)


@pytest.fixture(scope="module")
def bf16_models():
    v, port = _models(4, bf16_weights=True)
    return v, port.to(torch.bfloat16)


def _sub(v, name):
    return {"params": v["params"][name],
            "batch_stats": v["batch_stats"][name]}


def _assert_heads_close(got, want, rtol, atol_of_scale):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for field in ("bbox", "obj"):
            gv = getattr(g, field).float().numpy()
            wv = np.asarray(getattr(w, field), np.float32)
            assert gv.shape == wv.shape
            np.testing.assert_allclose(
                gv, wv, rtol=rtol, atol=atol_of_scale * np.abs(wv).max())


def test_space_to_depth_matches_jax(rng):
    x = rng.normal(size=(2, 6, 8, 5)).astype(np.float32)
    want = np.asarray(jax_dysoem.space_to_depth(jnp.asarray(x)))
    got = space_to_depth(torch.from_numpy(x))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    # channel (pi*2 + pj)*C + c holds pixel phase (pi, pj)
    np.testing.assert_array_equal(got.numpy()[..., 3 * 5:], x[:, 1::2, 1::2])


@pytest.mark.parametrize("site,hw", [(0, 16), (1, 16), (2, 12)])
def test_dynamic_soem_matches_flax(rng, f32_models, site, hw):
    """f32 on both sides. The port mixes the kernel first and flax contracts
    the experts after the conv, so the sums associate differently."""
    v, port = f32_models
    soem = getattr(port, f"soem_{site}")
    c = soem.attn_fc1.in_features // 4
    x = rng.normal(size=(2, hw, hw, c)).astype(np.float32)
    want = np.asarray(jax_dysoem.DynamicSOEM(in_channels=c).apply(
        _sub(v, f"soem_{site}"), jnp.asarray(x), 30.0, train=False))
    with torch.no_grad():
        got, sums = soem(torch.from_numpy(x), 30.0, emit_gap=True)
    assert got.shape == want.shape == (2, hw // 2, hw // 2, 2 * c)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(sums.numpy(), parity_sums(got).numpy(),
                               rtol=1e-6)


def test_simplified_fpn_matches_flax(rng, f32_models):
    v, port = f32_models
    maps = [rng.normal(size=(2, s, s, c)).astype(np.float32)
            for s, c in ((16, 64), (8, 128), (4, 256))]
    want = jax_dysoem.SimplifiedFPN().apply(
        _sub(v, "neck"), [jnp.asarray(m) for m in maps], train=False)
    with torch.no_grad():
        got = port.neck([torch.from_numpy(m).permute(0, 3, 1, 2)
                         for m in maps])
    for g, w in zip(got, want, strict=True):
        w = np.asarray(w)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w,
                                   rtol=1e-4, atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("size", [64, 48])
def test_dysoem_matches_flax(rng, f32_models, size):
    """Full width, batch 2, f32, per head against ``model.apply`` (flax runs
    its fused space-to-depth-as-conv form). 48 px gives site widths 12 and
    6, which the TPU kernel's W % 8 rule refused."""
    v, port = f32_models
    x = rng.uniform(size=(2, size, size, 3)).astype(np.float32)
    want = jax_dysoem.DySOEM_SimFPN().apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert [tuple(g.obj.shape) for g in got] == [
        (2, 3, size // s, size // s, 1) for s in (2, 4, 8)]
    _assert_heads_close(got, want, rtol=1e-4, atol_of_scale=1e-4)


@pytest.mark.parametrize("size", [32, 64])
def test_bf16_slice_matches_fold_soem_neck(rng, bf16_models, size):
    """The slice in bf16: uint8 frames -> per-head logits, the port through
    ``dyconv_plain`` against the JAX package's folded forward with its
    Pallas dyconv in interpret mode. Both sides round to bf16, at other
    places; the tolerance is that of tests/test_fold_soem_neck.py."""
    v, port = bf16_models
    x = (rng.uniform(size=(2, size, size, 3)) * 255).astype(np.uint8)
    jm = jax_dysoem.DySOEM_SimFPN(dtype=jnp.bfloat16)
    want = fold_soem_neck_forward(jm, v, dyconv=True,
                                  dyconv_interpret=True)(jnp.asarray(x))
    with torch.no_grad():
        got = port(preprocess(torch.from_numpy(x), size, torch.bfloat16))
    assert got[0].obj.dtype == torch.bfloat16
    for g, w in zip(got, want, strict=True):
        for field in ("bbox", "obj"):
            np.testing.assert_allclose(
                getattr(g, field).float().numpy(),
                np.asarray(getattr(w, field), np.float32),
                rtol=0.05, atol=0.05)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 0.05)])
def test_gap_handoff_equals_own_pooling(rng, f32_models, bf16_models, dtype,
                                        tol):
    """Handing the parity sums from site to site gives what each site gets
    by pooling its own input: the sums are of the stored values."""
    _, port = f32_models if dtype == torch.float32 else bf16_models
    x = torch.from_numpy(rng.uniform(size=(2, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        handed = port(x)
        # the same model, each site pooling its own input
        f = port.input_stem(x.to(dtype).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        feats = []
        for soem in port.soems:
            f = soem(f, port.attn_temperature)
            feats.append(f.permute(0, 3, 1, 2))
        own = port.yolo_head(port.neck(feats))
    for g, w in zip(handed, own, strict=True):
        for field in ("bbox", "obj"):
            torch.testing.assert_close(getattr(g, field).float(),
                                       getattr(w, field).float(),
                                       rtol=tol, atol=tol)


def test_weight_bridge_loads_a_flax_tree(f32_models):
    """Strict load, every flax leaf consumed, values unchanged; and the tree
    is the one flax itself builds."""
    v, port = f32_models
    jm = jax_dysoem.DySOEM_SimFPN()
    want = jax.eval_shape(jm.init, jax.random.key(0),
                          jnp.zeros((1, 64, 64, 3)))
    assert jax.tree.map(np.shape, want) == jax.tree.map(np.shape, v)
    sd = dysoem_state_dict_from_flax(v)
    n_flax = sum(np.size(x) for x in jax.tree.leaves(v))
    assert sum(np.size(x) for k, x in sd.items()
               if not k.endswith("num_batches_tracked")) == n_flax
    fresh = DySOEM_SimFPN().eval()
    load_flax_variables(fresh, v)   # load_state_dict(strict=True)
    for k, t in port.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], t), k
    # the experts stay one tensor in the flax layout, expert-major
    assert sd["soem_0.experts.kernel"].shape == (3, 3, 128, 3 * 64)
    assert sd["soem_0.attn_fc1.weight"].shape == (32, 128)


def test_detector_matches_jax(rng, f32_models):
    """uint8 frames at the detector size through both detectors, f32, the
    JAX one on its plain (unfolded) path. Head strides 2, 4, 8 come from
    the shapes on both sides."""
    v, port = f32_models
    x = (rng.uniform(size=(2, 64, 64, 3)) * 255).astype(np.uint8)
    want = jax_make_detector(
        jax_dysoem.DySOEM_SimFPN(), DYSOEM, 64, compute_dtype=jnp.float32,
        pallas_stem_variables=None)(v, jnp.asarray(x))
    got = make_detector(port, DYSOEM, 64, compute_dtype=torch.float32)(
        torch.from_numpy(x))
    _assert_same_detections(got, want)


def test_cpu_detector_launches_no_kernel(rng, bf16_models):
    _, port = bf16_models
    before = kernels.launch_counts()
    d = make_detector(port, DYSOEM, 32)(torch.from_numpy(
        (rng.uniform(size=(1, 32, 32, 3)) * 255).astype(np.uint8)))
    assert d.boxes.shape == (1, 300, 4) and torch.isfinite(d.scores).all()
    assert kernels.launch_counts() == before


def test_dysoem_constant_is_the_yaml():
    import yaml
    with open(Path(__file__).parents[1] / "conf/model/dy-soem_fpn.yaml") as f:
        cfg = yaml.safe_load(f)
    hp = cfg["hparams"]

    def lists(x):
        return [lists(i) for i in x] if isinstance(x, (list, tuple)) else x

    assert cfg["name"] == "DySOEM_SimFPN"
    assert lists(DYSOEM.anchors) == hp["anchors"]
    assert lists(DYSOEM.head_scales) == hp["head_scales"]
    assert DYSOEM.attention_temperature == hp["attention_temperature"]
    assert lists(DYSOEM.num_dy_conv) == hp["num_dy_conv"]
    assert lists(DYSOEM.dy_kernel_size) == hp["dy_kernel_size"]

    for key in ("lr", "lr_scheduler", "bbox_loss_fn"):
        assert getattr(DYSOEM, key) == hp[key], key
    assert vars(DYSOEM.optim) == hp["optim"]
    assert {k: lists(v) for k, v in vars(DYSOEM.loss_balancing).items()} \
        == hp["loss_balancing"]


def test_models_are_built_on_the_card_unless_told_otherwise():
    """``device`` defaults to "cuda" at both entry points; naming the CPU
    gives CPU parameters."""
    for fn in (build_model, seeded_model):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    model = build_model("DySOEM_SimFPN", DYSOEM, dtype=torch.bfloat16,
                        device="cpu")
    assert isinstance(model, DySOEM_SimFPN) and model.dtype == torch.bfloat16
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    assert len(model.yolo_head.detection_head) == 3
    seeded = seeded_model("DySOEM_SimFPN", DYSOEM, 0, "cpu")
    assert {p.device.type for p in seeded.parameters()} == {"cpu"}
    assert not seeded.training


def test_default_dtype_is_bf16_on_the_card_and_f32_elsewhere():
    """With no dtype named, both entry points take ``serving_dtype`` of the
    device: the kernels' bf16 on a CUDA device, float32 on the CPU."""
    assert serving_dtype("cuda") == torch.bfloat16
    assert serving_dtype(torch.device("cuda", 0)) == torch.bfloat16
    assert serving_dtype("cpu") == torch.float32
    for fn in (build_model, seeded_model):
        assert inspect.signature(fn).parameters["dtype"].default is None
    assert build_model("DySOEM_SimFPN", DYSOEM, device="cpu").dtype \
        == torch.float32
    assert build_model("DySOEM_SimFPN", DYSOEM, device="meta").dtype \
        == torch.float32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_soem_off_the_cpu_serves_through_the_kernel_or_raises(dtype):
    """Off the CPU an eval-mode bf16 SOEM with 3x3 experts reaches the
    ``dyconv`` dispatcher (which has no kernel for the meta device, and says
    so) and with other experts raises; a float32 SOEM, which no kernel
    claims, serves through the grouped conv. Training takes the grouped conv
    whatever the dtype."""
    soem = DynamicSOEM(8).to(device="meta", dtype=dtype).eval()
    x = torch.empty((2, 8, 8, 8), device="meta", dtype=dtype)
    if dtype == torch.bfloat16:
        with pytest.raises(ValueError, match="no dyconv kernel for device meta"):
            soem(x, 30.0)
        one = DynamicSOEM(8, dy_kernel_size=1).to(device="meta",
                                                  dtype=dtype).eval()
        with pytest.raises(RuntimeError, match="takes 3x3 experts"):
            one(x, 30.0)
    else:
        assert soem(x, 30.0).shape == (2, 4, 4, 16)
    assert soem.train()(x, 30.0).shape == (2, 4, 4, 16)


def _soem_flax_variables(soem):
    """The flax variables of one DynamicSOEM holding the port module's
    weights (numpy, f32)."""
    sd = {k: v.float().numpy() for k, v in soem.state_dict().items()
          if v.is_floating_point()}
    return {"params": {
        "attn_fc1": {"kernel": sd["attn_fc1.weight"].T.copy(),
                     "bias": sd["attn_fc1.bias"]},
        "attn_fc2": {"kernel": sd["attn_fc2.weight"].T.copy(),
                     "bias": sd["attn_fc2.bias"]},
        "experts": {"kernel": sd["experts.kernel"],
                    "bias": sd["experts.bias"]},
        "BatchNorm_0": {"scale": sd["bn.weight"], "bias": sd["bn.bias"]}},
        "batch_stats": {"BatchNorm_0": {"mean": sd["bn.running_mean"],
                                        "var": sd["bn.running_var"]}}}


@pytest.mark.parametrize("c,hw", [(8, 12), (16, 8)])
def test_bf16_soem_trains_like_flax(rng, c, hw):
    """A bf16 DynamicSOEM in training mode (the grouped conv, BatchNorm on
    the batch's statistics) against flax's ``apply(..., train=True)`` in
    bf16 on the same bf16-representable weights, and its backward runs.
    Both sides round to bf16 at other places (the port mixes the experts'
    kernel before the conv, flax contracts after it): rtol 0.05, atol 0.05
    on BN-normalised values of order one, the bound of the bf16 DySOEM
    test above."""
    soem = DynamicSOEM(c)
    with torch.no_grad():   # bf16 values, BN's scale and bias near 1 and 0
        for name, t in soem.named_parameters():
            w = rng.normal(size=t.shape) * (0.1 if "bias" in name else 0.3)
            if name == "bn.weight":
                w = 1.0 + w
            t.copy_(torch.from_numpy(w).to(torch.bfloat16).float())
    v = _soem_flax_variables(soem)
    soem = soem.to(torch.bfloat16).train()
    x = rng.normal(size=(2, hw, hw, c)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want, _ = jax_dysoem.DynamicSOEM(in_channels=c, dtype=jnp.bfloat16).apply(
        v, jnp.asarray(xb.float().numpy(), jnp.bfloat16), 30.0, train=True,
        mutable=["batch_stats"])
    kernel_before = kernels.launch_counts()["dyconv"]
    got = soem(xb.requires_grad_(), 30.0)
    assert got.dtype == torch.bfloat16
    assert got.shape == want.shape == (2, hw // 2, hw // 2, 2 * c)
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=0.05, atol=0.05)
    got.float().square().mean().backward()
    grad = soem.experts.kernel.grad
    assert grad is not None and bool(torch.isfinite(grad.float()).all())
    assert float(grad.float().abs().max()) > 0
    assert kernels.launch_counts()["dyconv"] == kernel_before
