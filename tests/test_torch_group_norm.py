"""GroupNorm(1) in inference (``uavdet_tpu_torch/ops/group_norm.py``) and
its kernel (``csrc/group_norm1.cu``).

On the CPU: the plain version against a float64 ``F.group_norm`` at the
kernel's edge shapes ``GN1_EDGE_SHAPES`` (bf16 within one bf16 unit in the
last place, the one rounding of the output; float32 within a few f32 units,
``_assert_close``); the operator under ``torch.library.opcheck``; the
chunking; and RTMUAVDet's ``MDyEncoder``, which takes the operator in eval
mode (counted ``group_norm1``, twice an encoder, four times a forward) and
``nn.GroupNorm`` in training (counted never).

Tests marked ``card`` need a CUDA device and skip without one (decided
inside the ``card`` fixture). This file imports no JAX, so that they run on
the card's host, which has none; there, without the suite's
``conftest.py``:

    python3 -m pytest tests/test_torch_group_norm.py -m card --noconftest

They hold the kernel against the plain version at the edge shapes and at
RTMUAVDet's two served shapes, (8, 192, 160, 160) and (8, 384, 80, 80) in
bf16, within one bf16 unit in the last place; two launches bitwise equal
(no atomics); a launch captured in a CUDA graph and replayed equal to the
eager one; and a graphed ``make_rtm_detector`` call whose device trace
shows the kernel four times and PyTorch's GroupNorm never.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from uavdet_tpu_torch import kernels, tracing
from uavdet_tpu_torch.ops.group_norm import (GN1_EDGE_SHAPES, gn1_chunks,
                                             group_norm1, group_norm1_plain)

BF16 = torch.bfloat16
SERVED_SHAPES = ((8, 192, 160, 160), (8, 384, 80, 80))   # 8 x 640 px
H100_SMS = 132


def _case(shape, dtype, seed=0, device="cpu"):
    """x (B, C, H, W) with mean ``shift`` times its unit spread, and an
    affine of the norm's scale in [0.5, 1.5] and shift around 0."""
    b, c, h, w, shift = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(shift, 1.0, (b, c, h, w)).astype(np.float32)
    weight = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0.0, 0.5, c).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device=device, dtype=dtype)
                 for a in (x, weight, bias))


def _reference(x, weight, bias, eps=1e-5):
    """float64 ``F.group_norm`` with one group on the same (rounded)
    operands."""
    return F.group_norm(x.double(), 1, weight.double(), bias.double(), eps)


def _bf16_ulp(v):
    """One bf16 unit in the last place at each value of ``v``."""
    _, e = torch.frexp(v.float().abs().clamp_min(2.0 ** -120))
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32),
                       (e - 8).to(torch.int32))


def _assert_close(got, want, x, weight):
    """bf16: within one bf16 unit in the last place of each value, or of
    1/256 of the largest |value| where that is larger (the output is
    rounded once; near 0, f32 errors of some 1e-7 exceed a unit of the
    value itself). float32: within 1e-5 of the largest |value| plus four
    f32 units of the affine's largest term, max |x| * max |rstd * weight|:
    PyTorch's GroupNorm applies x * a + b, which cancels at a map whose mean
    is far from 0."""
    diff = (got.double() - want.double()).abs()
    top = float(want.abs().max())
    if got.dtype == BF16:
        unit = _bf16_ulp(want.abs().clamp_min(top / 256)).double()
        assert bool((diff <= unit).all()), float((diff / unit).max())
    else:
        xd = x.double().reshape(x.shape[0], -1)
        a = float(weight.double().abs().max() / xd.std(1, correction=0).min())
        tol = 1e-5 * top + 4 * 2.0 ** -24 * float(xd.abs().max()) * a
        assert float(diff.max()) <= tol, (float(diff.max()), tol)


# --------------------------------------------------------------- on the CPU

@pytest.mark.parametrize("shape", GN1_EDGE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_plain_against_float64(shape, dtype):
    x, weight, bias = _case(shape, dtype)
    got = group_norm1_plain(x, weight, bias, 1e-5)
    assert got.dtype == dtype and got.shape == x.shape
    _assert_close(got, _reference(x, weight, bias), x, weight)


def test_naive_moments_would_fail_the_shifted_case():
    """The edge case with mean 1e3 times the spread tells a one-pass
    E[x^2] - E[x]^2 in float32 from the plain version."""
    shape = next(s for s in GN1_EDGE_SHAPES if s[-1] >= 1e3)
    x, weight, bias = _case(shape, torch.float32)
    xf = x.reshape(x.shape[0], -1)
    mean = xf.mean(1)
    var = (xf * xf).mean(1) - mean * mean
    scale = torch.rsqrt(var + 1e-5)[:, None, None, None] * \
        weight[None, :, None, None]
    naive = (x - mean[:, None, None, None]) * scale + \
        bias[None, :, None, None]
    want = _reference(x, weight, bias)
    assert float((naive - want).abs().max()) > \
        1e-3 * float(want.abs().max())


@pytest.mark.parametrize("shape", GN1_EDGE_SHAPES)
def test_operator_opcheck(shape):
    x, weight, bias = _case(shape, torch.float32)
    result = torch.library.opcheck(torch.ops.uavdet.group_norm1.default,
                                   (x, weight, bias, 1e-5))
    assert set(result.values()) == {"SUCCESS"}, result


def test_fake_gives_the_output_shape():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        x = torch.empty((8, 384, 80, 80), dtype=BF16)
        w = torch.empty((384,), dtype=BF16)
        y = torch.ops.uavdet.group_norm1(x, w, w, 1e-5)
        with pytest.raises(ValueError):
            torch.ops.uavdet.group_norm1(x, w[:5], w[:5], 1e-5)
    assert y.shape == x.shape and y.dtype == BF16


def test_chunks():
    """66 chunks a sample at both served shapes on an H100 (528 blocks, 4 a
    SM); a sample under MIN_CHUNK values takes one; a large batch one."""
    for (b, c, h, w) in SERVED_SHAPES:
        assert gn1_chunks(b, c * h * w, H100_SMS) == 66
    assert gn1_chunks(3, 128, H100_SMS) == 1
    assert gn1_chunks(1, 38400, H100_SMS) == 9
    assert gn1_chunks(1024, 10 ** 6, H100_SMS) == 1


def test_group_norm1_is_the_module_and_rejects_others():
    gn = nn.GroupNorm(1, 6, eps=1e-3)
    with torch.no_grad():
        gn.weight.uniform_(0.5, 1.5)
        gn.bias.normal_()
    x = torch.randn(3, 6, 5, 7) * 3 + 2
    assert torch.equal(group_norm1(x, gn), gn(x))
    xt = x.transpose(2, 3)
    assert torch.equal(group_norm1(xt, gn), gn(xt))
    for bad in (nn.GroupNorm(2, 6), nn.GroupNorm(1, 6, affine=False)):
        with pytest.raises(ValueError):
            group_norm1(x, bad)
    with pytest.raises(ValueError):
        group_norm1_plain(x.to(torch.float64), gn.weight, gn.bias, 1e-5)
    with pytest.raises(ValueError):
        group_norm1(torch.randn(3, 6, 5, 7, device="meta"), gn)


def _counts(module, *args):
    with tracing.collect() as t:
        module(*args)
    return t.counts.get("group_norm1")


def test_mdy_encoder_takes_the_operator_in_eval_only():
    from uavdet_tpu_torch.models.rtm_uav_det import MDyEncoder
    torch.manual_seed(0)
    enc = MDyEncoder(12, 8)
    x = torch.randn(2, 12, 8, 8)
    assert _counts(enc.eval(), x) == {"calls": 2, "frames": 4}
    with torch.no_grad():
        got = enc(x)
        want = enc.mlp_fc2(F.gelu(enc.mlp_fc1(enc.group_norm_out(
            torch.cat([enc.mdy_conv_1x1(enc.group_norm_in(x)),
                       enc.mdy_conv_3x3(enc.group_norm_in(x)),
                       enc.mdy_conv_5x5(enc.group_norm_in(x))], dim=1)
            + x)), approximate="tanh"))
    assert torch.equal(got, want)   # in float32 nn.GroupNorm itself
    enc.train()
    enc.dropout.p = 0.0
    assert _counts(enc, x) is None
    with torch.autocast("cpu", dtype=BF16):
        assert _counts(enc.eval(), x) is None


def test_rtm_forward_counts_four():
    from uavdet_tpu_torch.models.rtm_uav_det import RTMUAVDet
    torch.manual_seed(0)
    model = RTMUAVDet(det_scales=(16, 8)).eval()
    x = torch.rand(2, 64, 64, 3)
    with torch.no_grad():
        assert _counts(model, x) == {"calls": 4, "frames": 8}
    assert kernels.launch_counts()["group_norm1"] == 0   # no card here


# ----------------------------------------------------------------- on the card

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; this host has none")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _served(shape, card, seed):
    b, c, h, w = shape
    return _case((b, c, h, w, 0.0), BF16, seed, card)


@pytest.mark.card
@pytest.mark.parametrize("shape", GN1_EDGE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_kernel_at_the_edges(card, shape, dtype):
    x, weight, bias = _case(shape, dtype, 1, card)
    before = kernels.launch_counts()["group_norm1"]
    got = torch.ops.uavdet.group_norm1(x, weight, bias, 1e-5)
    assert kernels.launch_counts()["group_norm1"] == before + 1
    want = (group_norm1_plain(x, weight, bias, 1e-5) if dtype == BF16
            else _reference(x, weight, bias))
    _assert_close(got, want, x, weight)
    again = torch.ops.uavdet.group_norm1(x, weight, bias, 1e-5)
    assert torch.equal(again, got)


@pytest.mark.card
@pytest.mark.parametrize("shape", SERVED_SHAPES)
def test_kernel_at_the_served_shapes(card, shape):
    x, weight, bias = _served(shape, card, 2)
    got = torch.ops.uavdet.group_norm1(x, weight, bias, 1e-5)
    _assert_close(got, group_norm1_plain(x, weight, bias, 1e-5), x, weight)
    assert torch.equal(torch.ops.uavdet.group_norm1(x, weight, bias, 1e-5),
                       got)


@pytest.mark.card
def test_kernel_under_graph_capture(card):
    x, weight, bias = _served(SERVED_SHAPES[1], card, 3)
    eager = torch.ops.uavdet.group_norm1(x, weight, bias, 1e-5)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        torch.ops.uavdet.group_norm1(x, weight, bias, 1e-5)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = torch.ops.uavdet.group_norm1(x, weight, bias, 1e-5)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, eager)
    x.copy_(_served(SERVED_SHAPES[1], card, 4)[0])
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, torch.ops.uavdet.group_norm1(x, weight, bias,
                                                       1e-5))


@pytest.mark.card
def test_graphed_rtm_detector_runs_the_kernel(card):
    from torch.profiler import ProfilerActivity, profile

    from uavdet_tpu_torch.inference import make_rtm_detector
    from uavdet_tpu_torch.models.rtm_uav_det import rtm_det_scales
    from uavdet_tpu_torch.utils.seeding import seeded_rtm_model
    size = 640
    detect = make_rtm_detector(seeded_rtm_model(0, size, device=card), size,
                               rtm_det_scales(size))
    g = torch.Generator(device=card).manual_seed(5)
    x = torch.randint(0, 256, (8, size, size, 3), dtype=torch.uint8,
                      device=card, generator=g)
    with tracing.collect() as t:
        detect(x)   # a signature's first call runs eagerly
    assert t.counts["graph_eager"]["calls"] == 1
    assert t.counts["group_norm1"] == {"calls": 4, "frames": 32}
    detect(x)       # captured
    torch.cuda.synchronize()
    with tracing.collect() as t, profile(
            activities=[ProfilerActivity.CUDA]) as p:
        detect(x)
        torch.cuda.synchronize()
    assert t.counts["graph_replay"]["calls"] == 1
    assert "group_norm1" not in t.counts   # a replay runs no Python
    names = [e.name for e in p.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("gn1_moments" in n for n in names) == 4
    assert sum("gn1_apply" in n for n in names) == 4
    assert not any("RowwiseMoments" in n for n in names)
