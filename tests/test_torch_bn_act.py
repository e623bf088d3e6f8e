"""The conv blocks' epilogue in inference (``uavdet_tpu_torch/ops/bn_act.py``)
and its kernel (``csrc/bn_act.cu``).

On the CPU: the plain version against a float64 chain at the kernel's edge
shapes ``BN_ACT_EDGE_SHAPES`` in both layouts, both activations, with and
without a residual (within one bf16 unit in the last place, the one rounding
of the output); ``CNNBlock``, ``ResidualBlock``, ``ConvModule`` and
``DyConvModule`` in bf16 eval against their eager chains (PyTorch's
BatchNorm, activation and add; within two bf16 units); full-width DyYOLO and
DySOEM_SimFPN forwards against the eager chain and the float32 model; the
``bn_act`` count (70 a DyYOLO detector call, 72 a DyYOLO forward, 4 a
DySOEM_SimFPN call, none in training, under autocast or in float32); the
operator under ``torch.library.opcheck`` and its fake; the launch's grid;
the CUDA wrapper's refusals.

Tests marked ``card`` need a CUDA device and skip without one (decided
inside the ``card`` fixture). This file imports no JAX, so that they run on
the card's host, which has none; there, without the suite's
``conftest.py``:

    python3 -m pytest tests/test_torch_bn_act.py -m card --noconftest

They hold the kernel against the plain version at the edge shapes and at
the served maps (bitwise with LeakyReLU, within one bf16 unit with SiLU,
whose kernel takes the special-function unit's exp2 and reciprocal), two
launches bitwise; the operator on a residual in another layout than x; an
exported DyYOLO; a launch captured in a CUDA graph; a served detector
whose BatchNorm buffer changed in place, equal at its next replay to the
eager ``Detector``; and graphed DyYOLO and DySOEM_SimFPN calls whose device
trace shows the kernel 70 and 4 times and PyTorch's BatchNorm never.
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from uavdet_tpu_torch import kernels, tracing
from uavdet_tpu_torch.inference import make_detector
from uavdet_tpu_torch.models import DYSOEM, DYYOLO, layers
from uavdet_tpu_torch.models.layers import (CNNBlock, ConvModule,
                                            DyConvModule, ResidualBlock)
from uavdet_tpu_torch.ops.bn_act import (BN_ACT_EDGE_SHAPES, _bn_act_cuda,
                                         bn_act_grid, bn_act_plain)
from uavdet_tpu_torch.utils.seeding import seeded_model

BF16 = torch.bfloat16
CL = torch.channels_last
LAYOUTS = {"nchw": torch.contiguous_format, "channels_last": CL}
EPS = 1e-5
H100_SMS = 132
# the served maps: DyYOLO at 16 x 640 px (the first ResidualBlock's second
# block with its skip; the deepest ResidualBlock's output width), DySOEM at
# 32 x 1280 px (the input stem; the neck's highest resolution)
SERVED = (((16, 64, 320, 320), "leaky_relu", True),
          ((16, 512, 40, 40), "leaky_relu", False),
          ((32, 32, 1280, 1280), "silu", False),
          ((32, 64, 640, 640), "silu", False))


def _case(shape, layout, residual, seed=0, device="cpu", params=BF16):
    """x (B, C, H, W) bf16 in ``layout``, the BatchNorm's four vectors in
    ``params`` (running mean, a variance in [0.05, 4], an affine around 1
    and 0), and a residual in x's layout or None."""
    b, c, h, w = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 2.0, (b, c, h, w)).astype(np.float32)
    vectors = (rng.normal(0.0, 1.0, c), rng.uniform(0.05, 4.0, c),
               rng.uniform(0.5, 1.5, c), rng.normal(0.0, 0.5, c))
    r = rng.normal(0.0, 1.0, (b, c, h, w)).astype(np.float32)

    def map_(a):
        return torch.from_numpy(a).to(device=device, dtype=BF16).contiguous(
            memory_format=LAYOUTS[layout])
    return (map_(x), *(torch.from_numpy(v.astype(np.float32)).to(
        device=device, dtype=params) for v in vectors),
        map_(r) if residual else None)


def _reference(x, mean, var, weight, bias, act, residual):
    """The epilogue in float64 on the same (rounded) operands."""
    def col(v):
        return v.double()[:, None, None]
    y = (x.double() - col(mean)) / torch.sqrt(col(var) + EPS) * col(weight) \
        + col(bias)
    y = F.leaky_relu(y, 0.1) if act == "leaky_relu" else F.silu(y)
    return y if residual is None else y + residual.double()


def _bf16_ulp(v):
    """One bf16 unit in the last place at each value of ``v``."""
    _, e = torch.frexp(v.float().abs().clamp_min(2.0 ** -120))
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32),
                       (e - 8).to(torch.int32))


def _assert_within(got, want, units, floor=1 / 256, terms=None):
    """Within ``units`` bf16 units in the last place of each value, or of
    ``floor`` times the largest |value| where that is larger (near 0, f32
    errors of the terms exceed a unit of the value itself), or of the
    |value| of ``terms`` where that is larger."""
    diff = (got.double() - want.double()).abs()
    top = float(want.abs().max())
    scale = want.abs().double().clamp_min(top * floor)
    if terms is not None:
        scale = torch.maximum(scale, terms.abs().double())
    unit = _bf16_ulp(scale).double()
    assert bool((diff <= units * unit).all()), float((diff / unit).max())


# --------------------------------------------------------------- on the CPU

@pytest.mark.parametrize("residual", [False, True], ids=["plain", "skip"])
@pytest.mark.parametrize("act", ["leaky_relu", "silu"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("shape", BN_ACT_EDGE_SHAPES)
def test_plain_against_float64(shape, layout, act, residual):
    args = _case(shape, layout, residual)
    got = bn_act_plain(*args[:5], EPS, act, args[5])
    assert got.dtype == BF16 and got.shape == args[0].shape
    assert got.is_contiguous(memory_format=LAYOUTS[layout])
    _assert_within(got, _reference(*args[:5], act, args[5]), 1)


def test_plain_takes_f32_vectors_as_bf16_ones():
    """The BatchNorm's vectors in float32 give what the same values in bf16
    give (the plain version reads both as f32)."""
    args = _case((2, 16, 5, 6), "channels_last", True)
    f32 = [t.float() for t in args[1:5]]
    assert torch.equal(bn_act_plain(args[0], *f32, EPS, "silu", args[5]),
                       bn_act_plain(*args[:5], EPS, "silu", args[5]))


def _randomize(module, seed):
    """Draws every BatchNorm's statistics and affine away from the identity,
    and a DyConvModule's experts; -> the module in bf16, eval mode."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.BatchNorm2d):
                c = m.num_features
                m.running_mean.copy_(torch.randn(c, generator=g))
                m.running_var.copy_(torch.rand(c, generator=g) * 2 + 0.25)
                m.weight.copy_(torch.rand(c, generator=g) + 0.5)
                m.bias.copy_(torch.randn(c, generator=g) * 0.5)
            if isinstance(m, DyConvModule):
                m.weights.copy_(torch.randn(m.weights.shape, generator=g)
                                * 0.2)
    return module.to(BF16).eval()


def _eager(monkeypatch):
    """Turns the fused epilogue off: every module takes PyTorch's chain."""
    monkeypatch.setattr(layers, "fused_epilogue", lambda y, bn: False)


def _last_bn_output(module, *args):
    """``module(*args)`` and the output of the last BatchNorm it ran: the
    eager chain rounds it, and its activation, at their own magnitude,
    which near a SiLU's or an add's zero is above the result's."""
    outs = []
    handles = [m.register_forward_hook(lambda m, a, out: outs.append(out))
               for m in module.modules() if isinstance(m, nn.BatchNorm2d)]
    try:
        return module(*args), outs[-1]
    finally:
        for h in handles:
            h.remove()


def _counts(fn, *args):
    with tracing.collect() as t:
        fn(*args)
    return t.counts.get("bn_act")


MODULES = {
    "cnnblock": lambda: CNNBlock(16, 24, 3, 1, 1),
    "cnnblock_s2": lambda: CNNBlock(16, 24, 3, 2, 1),
    "residual": lambda: ResidualBlock(16, num_repeats=2),
    "no_skip": lambda: ResidualBlock(16, use_residual=False),
    "convmodule": lambda: ConvModule(16, 24, 3, padding=1),
    "dyconv_3x3": lambda: DyConvModule(16, 24, 3, 1, 1),
    "dyconv_1x1": lambda: DyConvModule(16, 24, 1),
}
# bn_act calls a forward of each
MODULE_CALLS = {"cnnblock": 1, "cnnblock_s2": 1, "residual": 4, "no_skip": 2,
                "convmodule": 1, "dyconv_3x3": 1, "dyconv_1x1": 1}
CHAINED = ("residual", "no_skip")   # a conv after a fused epilogue


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", list(MODULES))
def test_module_against_its_eager_chain(monkeypatch, name, layout):
    torch.manual_seed(0)
    module = _randomize(MODULES[name](), 1)
    x = torch.randn(3, 16, 9, 11).to(BF16).contiguous(
        memory_format=LAYOUTS[layout])
    args = (x, 30.0) if name.startswith("dyconv") else (x,)
    with torch.no_grad():
        assert _counts(module, *args) == {"calls": MODULE_CALLS[name],
                                          "frames": 3 * MODULE_CALLS[name]}
        got = module(*args)
        _eager(monkeypatch)
        assert _counts(module, *args) is None
        want, normed = _last_bn_output(module, *args)
    assert got.dtype == BF16
    # a ResidualBlock's first block feeds its second conv, whose sums carry
    # the first's rounding: there two units of the largest value
    _assert_within(got, want, 2, 1 if name in CHAINED else 1 / 256, normed)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_cnnblock_adds_the_residual_after_the_activation(monkeypatch,
                                                         layout):
    torch.manual_seed(0)
    block = _randomize(CNNBlock(8, 16, 1), 2)
    x = torch.randn(2, 8, 5, 7).to(BF16).contiguous(
        memory_format=LAYOUTS[layout])
    r = torch.randn(2, 16, 5, 7).to(BF16).contiguous(
        memory_format=LAYOUTS[layout])
    with torch.no_grad():
        got = block(x, r)
        y = block.conv(x)
        one = bn_act_plain(y, block.bn.running_mean, block.bn.running_var,
                           block.bn.weight, block.bn.bias, block.bn.eps,
                           "leaky_relu", r)
        _eager(monkeypatch)
        eager, normed = _last_bn_output(block, x, r)
    assert torch.equal(got, one)
    _assert_within(got, eager, 2,
                   terms=torch.maximum(normed.abs(), r.abs()))


@pytest.fixture(scope="module")
def full_models():
    """Full-width DyYOLO and DySOEM_SimFPN, float32 and bf16 copies."""
    out = {}
    for name, hp in (("DyYOLO", DYYOLO), ("DySOEM_SimFPN", DYSOEM)):
        f32 = seeded_model(name, hp, 0, device="cpu",
                           dtype=torch.float32).eval()
        out[name] = (hp, f32, copy.deepcopy(f32).to(BF16))
    return out


def _heads(model, x):
    with torch.no_grad():
        return torch.cat([torch.cat([o.obj.flatten(), o.bbox.flatten()])
                          for o in model(x)]).float()


@pytest.mark.parametrize("name", ["DyYOLO", "DySOEM_SimFPN"])
def test_full_width_forward_against_the_eager_chain(monkeypatch, full_models,
                                                    name):
    """The heads of a bf16 forward at 64 px: within four bf16 units of the
    largest logit from the eager chain's, and no farther from the float32
    model's than the eager chain's by more than one."""
    _, f32, bf16 = full_models[name]
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(3))
    ref = _heads(f32, x)
    fused = _heads(bf16, x)
    _eager(monkeypatch)
    eager = _heads(bf16, x)
    unit = float(_bf16_ulp(ref.abs().max()))
    assert float((fused - eager).abs().max()) <= 4 * unit
    assert float((fused - ref).abs().max()) <= \
        float((eager - ref).abs().max()) + unit


def test_counts_where_it_engages(full_models):
    """70 calls a DyYOLO detector call (every CNNBlock and DyConvModule
    outside the stem kernels), 72 a DyYOLO forward (with the stem's two
    DyConvModules), 4 a DySOEM_SimFPN call (its input stem and the neck's
    three ConvModules), at any batch; none in float32, under autocast or in
    training."""
    frames = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(4))
    hp, f32, bf16 = full_models["DyYOLO"]
    assert _counts(make_detector(bf16, hp, 64), frames) == {
        "calls": 70, "frames": 140}
    x = frames.to(BF16) / 255
    with torch.no_grad():
        assert _counts(bf16, x) == {"calls": 72, "frames": 144}
        assert _counts(f32, x.float()) is None
        with torch.autocast("cpu", dtype=BF16):
            assert _counts(f32, x.float()) is None
    hp, f32, bf16 = full_models["DySOEM_SimFPN"]
    assert _counts(make_detector(bf16, hp, 64), frames[:1]) == {
        "calls": 4, "frames": 4}
    assert _counts(make_detector(f32, hp, 64), frames[:1]) is None
    train = copy.deepcopy(bf16).train()
    with torch.no_grad():
        assert _counts(train, x) is None
    assert kernels.launch_counts()["bn_act"] == 0   # no card here


@pytest.mark.parametrize("case", ["channels_last_skip", "nchw_silu"])
def test_operator_opcheck(case):
    layout, act, residual = (("channels_last", "leaky_relu", True)
                             if case == "channels_last_skip"
                             else ("nchw", "silu", False))
    args = _case((2, 16, 5, 7), layout, residual)
    result = torch.library.opcheck(
        torch.ops.uavdet.bn_act.default, (*args[:5], EPS, act, args[5]))
    assert set(result.values()) == {"SUCCESS"}, result


def test_fake_gives_the_output_shape():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        x = torch.empty((16, 64, 320, 320), dtype=BF16).contiguous(
            memory_format=CL)
        v = torch.empty((64,), dtype=BF16)
        y = torch.ops.uavdet.bn_act(x, v, v, v, v, EPS, "leaky_relu", x)
        with pytest.raises(ValueError):
            torch.ops.uavdet.bn_act(x, v[:8], v, v, v, EPS, "silu", None)
        with pytest.raises(ValueError):
            torch.ops.uavdet.bn_act(x, v, v, v, v, EPS, "relu", None)
    assert y.shape == x.shape and y.dtype == BF16
    assert y.is_contiguous(memory_format=CL)


def test_grid():
    """4 blocks a SM on an H100 at the served maps; on channels_last maps
    the launch's threads a multiple of C / 8; one block for a small map."""
    for (b, c, h, w), _, _ in SERVED:
        assert bn_act_grid(b * c * h * w, c, True, H100_SMS) == 528
    for c in (24, 40, 8 * 129):
        grid = bn_act_grid(10 ** 8, c, True, H100_SMS)
        assert grid * 256 % (c // 8) == 0 and grid >= 528
    assert bn_act_grid(3 * 24 * 4 * 6, 24, True, H100_SMS) == 3
    assert bn_act_grid(3 * 24 * 4 * 6, 24, False, H100_SMS) == 1
    assert bn_act_grid(2 * 12 * 7 * 3, 12, True, H100_SMS) == 1


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    """Before any launch: x neither channels_last nor NCHW, a residual in
    another layout, a float32 x, vectors of two types, too many channels."""
    x, mean, var, weight, bias, r = _case((2, 16, 6, 8), "channels_last",
                                          True)
    vectors = (mean, var, weight, bias)
    for bad_x, bad_r in ((x.transpose(2, 3), None),          # strided
                         (x[:, :, :, :4], None),              # a slice
                         (x, r.contiguous())):                # NCHW residual
        with pytest.raises(ValueError):
            _bn_act_cuda(bad_x, *vectors, EPS, "leaky_relu", bad_r)
    with pytest.raises(ValueError):
        _bn_act_cuda(x.float(), *vectors, EPS, "silu", None)
    with pytest.raises(ValueError):
        _bn_act_cuda(x, mean.float(), var, weight, bias, EPS, "silu", None)
    with pytest.raises(ValueError):
        _bn_act_cuda(x, *vectors, EPS, "silu", r[:1])
    big = torch.zeros((1, 4104, 1, 1), dtype=BF16)
    v = torch.ones(4104, dtype=BF16)
    with pytest.raises(ValueError):
        _bn_act_cuda(big, v, v, v, v, EPS, "silu", None)
    with pytest.raises(ValueError):
        torch.ops.uavdet.bn_act(x.to("meta"), *(t.to("meta") for t in
                                                vectors), EPS, "silu", None)


# ----------------------------------------------------------------- on the card

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; this host has none")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _launch(args, act):
    return torch.ops.uavdet.bn_act(*args[:5], EPS, act, args[5])


def _assert_kernel(got, args, act):
    want = bn_act_plain(*args[:5], EPS, act, args[5])
    assert got.stride() == args[0].stride()
    if act == "leaky_relu":
        assert torch.equal(got, want)
    else:
        _assert_within(got, want, 1)


@pytest.mark.card
@pytest.mark.parametrize("params", [BF16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("residual", [False, True], ids=["plain", "skip"])
@pytest.mark.parametrize("act", ["leaky_relu", "silu"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("shape", BN_ACT_EDGE_SHAPES)
def test_kernel_at_the_edges(card, shape, layout, act, residual, params):
    args = _case(shape, layout, residual, 1, card, params)
    before = kernels.launch_counts()["bn_act"]
    got = _launch(args, act)
    assert kernels.launch_counts()["bn_act"] == before + 1
    _assert_kernel(got, args, act)
    assert torch.equal(_launch(args, act), got)


@pytest.mark.card
@pytest.mark.parametrize("served", SERVED, ids=["dyyolo_skip", "dyyolo_deep",
                                                "dysoem_front", "dysoem_neck"])
def test_kernel_at_the_served_shapes(card, served):
    shape, act, residual = served
    args = _case(shape, "channels_last", residual, 2, card)
    got = _launch(args, act)
    _assert_kernel(got, args, act)
    assert torch.equal(_launch(args, act), got)


@pytest.mark.card
def test_the_operator_takes_the_layouts_of_the_call(card):
    """A residual in another layout than x, or x in neither, is made dense
    in x's layout before the launch, as an exported program's call needs
    (its trace may have seen other strides)."""
    args = _case((2, 32, 6, 10), "channels_last", True, 4, card)
    want = bn_act_plain(*args[:5], EPS, "leaky_relu", args[5])
    nchw_r = args[5].contiguous()
    got = torch.ops.uavdet.bn_act(*args[:5], EPS, "leaky_relu", nchw_r)
    assert torch.equal(got, want) and got.stride() == args[0].stride()
    strided = args[0].transpose(2, 3).contiguous().transpose(2, 3)
    got = torch.ops.uavdet.bn_act(strided, *args[1:5], EPS, "leaky_relu",
                                  nchw_r)
    assert torch.equal(got, want)


@pytest.mark.card
def test_an_exported_detector_runs_the_kernel(card):
    """``export.export_detector``'s DyYOLO on the card: 70 launches a call,
    its detections those of the live detector."""
    from uavdet_tpu_torch.export import export_detector, load_detector
    from uavdet_tpu_torch.inference import Detector
    model = seeded_model("DyYOLO", DYYOLO, 0, device=card)
    blob = export_detector(model, DYYOLO, 640, 2)
    g = torch.Generator(device=card).manual_seed(22)
    x = torch.randint(0, 256, (2, 640, 640, 3), dtype=torch.uint8,
                      device=card, generator=g)
    before = kernels.launch_counts()["bn_act"]
    boxes, scores, valid = load_detector(blob)(x)
    assert kernels.launch_counts()["bn_act"] == before + 70
    with torch.inference_mode():
        want = Detector(model, DYYOLO, 640)(x)
    assert torch.equal(valid, want[2])
    assert float((scores - want[1]).abs().max()) <= 2.5e-3


@pytest.mark.card
def test_kernel_under_graph_capture(card):
    args = _case((16, 128, 80, 80), "channels_last", True, 3, card)
    eager = _launch(args, "leaky_relu")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _launch(args, "leaky_relu")
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = _launch(args, "leaky_relu")
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, eager)
    args[2].mul_(2.0)   # running_var, in place: the replay reads it there
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, _launch(args, "leaky_relu"))
    assert not torch.equal(y, eager)


@pytest.mark.card
def test_a_bn_buffer_changed_in_place_shows_in_the_next_replay(card):
    from uavdet_tpu_torch.inference import Detector
    model = seeded_model("DyYOLO", DYYOLO, 1, device=card)
    detect = make_detector(model, DYYOLO, 640)
    g = torch.Generator(device=card).manual_seed(21)
    x = torch.randint(0, 256, (2, 640, 640, 3), dtype=torch.uint8,
                      device=card, generator=g)
    twin = Detector(model, DYYOLO, 640)
    for _ in range(3):   # eager, captured, replayed
        before = detect(x)
    bn = next(m for m in model.layers[-1].modules()   # the last head's
              if isinstance(m, nn.BatchNorm2d))
    with torch.no_grad():
        bn.running_var.mul_(4.0)
    with tracing.collect() as t:
        changed = detect(x)
    assert t.counts["graph_replay"]["calls"] == 1
    with torch.inference_mode():
        want = twin(x)
    assert all(torch.equal(a, b) for a, b in zip(changed, want))
    assert not all(torch.equal(a, b) for a, b in zip(changed, before))


@pytest.mark.card
@pytest.mark.parametrize("name,size,batch,launches", [
    ("DyYOLO", 640, 2, 70), ("DySOEM_SimFPN", 1280, 1, 4)])
def test_graphed_detectors_run_the_kernel(card, name, size, batch, launches):
    from torch.profiler import ProfilerActivity, profile
    hp = DYYOLO if name == "DyYOLO" else DYSOEM
    detect = make_detector(seeded_model(name, hp, 0, device=card), hp, size)
    g = torch.Generator(device=card).manual_seed(5)
    x = torch.randint(0, 256, (batch, size, size, 3), dtype=torch.uint8,
                      device=card, generator=g)
    before = kernels.launch_counts()["bn_act"]
    with tracing.collect() as t:
        detect(x)   # a signature's first call runs eagerly
    assert t.counts["graph_eager"]["calls"] == 1
    assert t.counts["bn_act"] == {"calls": launches,
                                  "frames": launches * batch}
    assert kernels.launch_counts()["bn_act"] == before + launches
    detect(x)       # captured
    torch.cuda.synchronize()
    with tracing.collect() as t, profile(
            activities=[ProfilerActivity.CUDA]) as p:
        detect(x)
        torch.cuda.synchronize()
    assert t.counts["graph_replay"]["calls"] == 1
    names = [e.name for e in p.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("bn_act_" in n for n in names) == launches
    assert not any("batch_norm" in n for n in names)
