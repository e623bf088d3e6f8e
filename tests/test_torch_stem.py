"""The port's two-pass dynamic-conv stem (uavdet_tpu_torch/ops/stem.py)
against the JAX package's Pallas kernels (interpret mode) and flax layers.

On the CPU the stem runs the plain PyTorch versions of kernels A and B, the
ones the card compares its kernels with. Both sides round the same operands
to bf16 and accumulate in f32; only the order of the f32 sums differs, which
moves a result across a bf16 rounding boundary rarely (one ulp, 2^-8
relative). Hence the bound used throughout: at least 99.9 % of elements
bitwise equal, and all within rtol 1.6e-2, atol 1e-2.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from uavdet_tpu.models import DyYOLO as JaxDyYOLO
from uavdet_tpu.models.layers import DyConvModule as JaxDyConv
from uavdet_tpu.ops.pallas_stem import mix_and_fold as jax_mix_and_fold
from uavdet_tpu.ops.pallas_stem_split import fused_stem_forward as jax_stem
from uavdet_tpu.ops.pallas_stem_split import pallas_l1, pallas_l2
from uavdet_tpu_torch.models import DyYOLO
from uavdet_tpu_torch import kernels
from uavdet_tpu_torch.ops.stem import (L1_EDGE_SHAPES, L2_EDGE_SHAPES,
                                       _stem_l1_cuda, _stem_l2_cuda,
                                       fused_stem_forward, mix_and_fold,
                                       stem_l1, stem_l1_plain, stem_l2,
                                       stem_l2_plain)
from uavdet_tpu_torch.utils.weights import load_flax_variables

CFG = (("DyConv", 32, 3, 1), ("DyConv", 64, 3, 2), ("B", 1), ("S",))
RTOL, ATOL, MIN_EQUAL = 1.6e-2, 1e-2, 0.999
# the edge shapes the TPU kernel takes as well: H a multiple of 16
TPU_L2_EDGE_SHAPES = tuple(s for s in L2_EDGE_SHAPES
                           if s[1] % 16 == 0 and s[2] % 128 == 0)
# kernel A's: the TPU kernel takes even H and W (the stem gate's rule)
TPU_L1_EDGE_SHAPES = tuple(s for s in L1_EDGE_SHAPES
                           if s[1] % 16 == 0 and s[2] % 128 == 0)


def perturb_bn(variables, rng):
    """Random BN affine and running statistics, so that folding BN into the
    kernel matrices is exercised (flax initializes them to identity)."""
    def walk(p, s):
        for k in p:
            if k.startswith("BatchNorm"):
                n = p[k]["scale"].shape
                p[k] = dict(scale=rng.uniform(0.8, 1.2, n).astype(np.float32),
                            bias=rng.normal(0, 0.05, n).astype(np.float32))
                s[k] = dict(mean=rng.normal(0, 0.05, n).astype(np.float32),
                            var=rng.uniform(0.8, 1.2, n).astype(np.float32))
            elif isinstance(p[k], dict) and k in s:
                walk(p[k], s[k])

    v = jax.tree.map(np.asarray, variables)
    walk(v["params"], v["batch_stats"])
    return v


@pytest.fixture(scope="module")
def stem_models():
    jm = JaxDyYOLO(layer_config=CFG, attn_temperature=30.0)
    v = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((1, 64, 64, 3)))
    v = perturb_bn(v, np.random.default_rng(5))
    tm = DyYOLO(CFG, attn_temperature=30.0).eval()
    load_flax_variables(tm, v)
    return v, tm


def _frames(rng, shape, uint8):
    u8 = (rng.uniform(size=shape) * 255).astype(np.uint8)
    return u8 if uint8 else u8.astype(np.float32) / 255.0


def _assert_bf16_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert (got == want).mean() >= MIN_EQUAL, (got == want).mean()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("uint8", [True, False])
def test_kernel_a_plain_matches_pallas_l1(rng, uint8):
    x = _frames(rng, (2, 64, 128, 3), uint8)
    k1 = (rng.normal(size=(2, 32, 28)) * 0.05).astype(np.float32)
    banks, sums = pallas_l1(jnp.asarray(x), jnp.asarray(k1), interpret=True)
    # bank q = 2 * row parity + column parity, channel-major
    want = np.zeros((2, 64, 128, 32), np.float32)
    for q, bank in enumerate(banks):
        rp, cp = divmod(q, 2)
        want[:, rp::2, cp::2] = np.asarray(
            bank, np.float32)[:, :, :32, :64].transpose(0, 2, 3, 1)
    a1, got_sums = stem_l1_plain(torch.from_numpy(x), torch.from_numpy(k1))
    _assert_bf16_close(a1.float().numpy(), want)
    # sums of the stored bf16 values: the same values in another order
    np.testing.assert_allclose(got_sums.numpy(), np.asarray(sums),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("h", [64, 96])
@pytest.mark.parametrize("uint8", [True, False])
def test_stem_matches_fused_stem_forward(rng, stem_models, h, uint8):
    """H=96 is the height the TPU kernels over-allocate for (not a
    multiple of 64); uint8 takes the /255-folded path."""
    v, tm = stem_models
    x = _frames(rng, (2, h, 128, 3), uint8)
    p, s = v["params"]["net"], v["batch_stats"]["net"]
    want = jax_stem(jnp.asarray(x), p["DyConvModule_0"], s["DyConvModule_0"],
                    p["DyConvModule_1"], s["DyConvModule_1"], 30.0,
                    interpret=True)
    got = fused_stem_forward(torch.from_numpy(x), tm.layers[0], tm.layers[1],
                             30.0)
    assert got.dtype == torch.bfloat16 and got.shape == (2, h // 2, 64, 64)
    _assert_bf16_close(got.float().numpy(), want)


def test_stem_matches_flax_dyconv_pair(rng, stem_models):
    """Against the two flax DyConv layers in f32: the stem's bf16 rounding
    is the whole difference (tolerance of tests/test_pallas_stem_split.py)."""
    v, tm = stem_models
    x = _frames(rng, (2, 64, 128, 3), uint8=False)
    p, s = v["params"]["net"], v["batch_stats"]["net"]
    y = JaxDyConv(32, 3, 1, 1).apply(
        {"params": p["DyConvModule_0"], "batch_stats": s["DyConvModule_0"]},
        jnp.asarray(x), 30.0, False)
    want = np.asarray(JaxDyConv(64, 3, 2, 1).apply(
        {"params": p["DyConvModule_1"], "batch_stats": s["DyConvModule_1"]},
        y, 30.0, False))
    got = fused_stem_forward(torch.from_numpy(x), tm.layers[0], tm.layers[1],
                             30.0).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0.1, atol=0.03)
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999


def test_mix_and_fold_matches_jax(rng, stem_models):
    """f32 on both sides; the 4-term expert sum may associate differently."""
    v, tm = stem_models
    p, s = v["params"]["net"], v["batch_stats"]["net"]
    attn = rng.dirichlet(np.ones(4), size=3).astype(np.float32)
    for i, out_c in ((0, 32), (1, 64)):
        dp, ds = p[f"DyConvModule_{i}"], s[f"DyConvModule_{i}"]
        bn_p, bn_s = dp["BatchNorm_0"], ds["BatchNorm_0"]
        want = jax_mix_and_fold(jnp.asarray(dp["experts"]), jnp.asarray(attn),
                                bn_p["scale"], bn_p["bias"], bn_s["mean"],
                                bn_s["var"], out_channels=out_c)
        got = mix_and_fold(tm.layers[i].weights, torch.from_numpy(attn),
                           tm.layers[i].bn)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-7)


def test_kernel_a_plain_odd_shape_matches_numpy(rng):
    """Odd sizes, which the TPU kernels do not take: zero padding on the
    input only, against a float64 numpy conv of the same bf16 operands."""
    x = rng.uniform(size=(2, 9, 13, 3)).astype(np.float32)
    k1 = (rng.normal(size=(2, 32, 28)) * 0.3).astype(np.float32)
    a1, sums = stem_l1_plain(torch.from_numpy(x), torch.from_numpy(k1))
    xq = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
    kq = torch.from_numpy(k1).to(torch.bfloat16).double().numpy()
    xp = np.pad(xq, ((0, 0), (1, 1), (1, 1), (0, 0)))
    patches = np.stack([xp[:, ki:ki + 9, kj:kj + 13, c]
                        for ki in range(3) for kj in range(3)
                        for c in range(3)], axis=-1)      # (2, 9, 13, 27)
    acc = np.einsum("bhwt,bot->bhwo", patches, kq[..., :27]) \
        + kq[:, None, None, :, 27]
    want = acc / (1.0 + np.exp(-acc))
    np.testing.assert_allclose(a1.float().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(sums.numpy(),
                               a1.double().sum(dim=(1, 2)).numpy(),
                               rtol=1e-6)


def test_stem_kernels_reject_other_devices():
    """The dispatch rule: CPU -> plain version, CUDA -> kernel, else raise."""
    x = torch.empty((1, 8, 8, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no stem kernel"):
        stem_l1(x, torch.empty((1, 32, 28), device="meta"))
    with pytest.raises(ValueError, match="no stem kernel"):
        stem_l2(torch.empty((1, 8, 8, 32), dtype=torch.bfloat16,
                            device="meta"),
                torch.empty((1, 64, 289), device="meta"))


def test_l2_edge_shapes_straddle_the_kernel_tile():
    """The tuple the smoke test also reads: odd H and W, and output sizes on
    both sides of the 16 x 16 output tile."""
    assert any(h % 2 and w % 2 for _, h, w in L2_EDGE_SHAPES)
    outs = [((h + 1) // 2, (w + 1) // 2) for _, h, w in L2_EDGE_SHAPES]
    assert any(ho < 16 and wo < 16 for ho, wo in outs)
    assert any(ho % 16 == 1 for ho, _ in outs)
    assert any(wo % 16 == 1 for _, wo in outs)
    assert any(ho % 16 == 15 or wo % 16 == 15 for ho, wo in outs)
    assert TPU_L2_EDGE_SHAPES


@pytest.mark.parametrize("shape", L2_EDGE_SHAPES)
def test_kernel_b_plain_edge_shapes_match_numpy(rng, shape):
    """Kernel B's plain version at the edges of the CUDA kernel's tiling,
    against a float64 stride-2 conv of the same bf16 operands: zero padding
    on a1 only, ceil(H/2) x ceil(W/2) outputs."""
    b, h, w = shape
    a1 = torch.from_numpy(rng.normal(size=(b, h, w, 32)).astype(
        np.float32) * 0.5).to(torch.bfloat16)
    k2 = (rng.normal(size=(b, 64, 289)) * 0.08).astype(np.float32)
    got = stem_l2(a1, torch.from_numpy(k2))
    ho, wo = (h + 1) // 2, (w + 1) // 2
    assert got.shape == (b, ho, wo, 64) and got.dtype == torch.bfloat16
    kq = torch.from_numpy(k2).to(torch.bfloat16).double().numpy()
    ap = np.pad(a1.double().numpy(), ((0, 0), (1, 2), (1, 2), (0, 0)))
    patches = np.concatenate(
        [ap[:, ki:ki + 2 * ho:2, kj:kj + 2 * wo:2]
         for ki in range(3) for kj in range(3)], axis=-1)   # (b, ho, wo, 288)
    acc = np.einsum("bhwt,bot->bhwo", patches, kq[..., :288]) \
        + kq[:, None, None, :, 288]
    want = acc / (1.0 + np.exp(-acc))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("shape", TPU_L2_EDGE_SHAPES)
def test_kernel_b_plain_edge_shapes_match_pallas_l2(rng, shape):
    """Where the TPU kernel takes the shape: ``pallas_l2`` in interpret mode
    on the banks ``pallas_l1`` makes, against the plain version on the same
    first activation."""
    b, h, w = shape
    x = _frames(rng, (b, h, w, 3), uint8=False)
    k1 = (rng.normal(size=(b, 32, 28)) * 0.05).astype(np.float32)
    k2 = (rng.normal(size=(b, 64, 289)) * 0.05).astype(np.float32)
    banks, _ = pallas_l1(jnp.asarray(x), jnp.asarray(k1), interpret=True)
    want = pallas_l2(banks, jnp.asarray(k2), h=h, wq=w // 2, interpret=True)
    a1 = np.zeros((b, h, w, 32), np.float32)
    for q, bank in enumerate(banks):
        rp, cp = divmod(q, 2)
        a1[:, rp::2, cp::2] = np.asarray(
            bank, np.float32)[:, :, :h // 2, :w // 2].transpose(0, 2, 3, 1)
    got = stem_l2_plain(torch.from_numpy(a1).to(torch.bfloat16),
                        torch.from_numpy(k2))
    _assert_bf16_close(got.float().numpy(), want)


def test_kernel_b_wrapper_rules():
    """The kernel's wrapper raises before any launch on shapes and types
    the kernel does not take, whatever the device."""
    a1 = torch.zeros((1, 8, 8, 32), dtype=torch.bfloat16)
    k2 = torch.zeros((1, 64, 289))
    with pytest.raises(ValueError, match="a1"):
        _stem_l2_cuda(a1.float(), k2)
    with pytest.raises(ValueError, match="a1"):
        _stem_l2_cuda(a1[..., :16], k2)
    with pytest.raises(ValueError, match="k2"):
        _stem_l2_cuda(a1, k2[:, :, :288])


def test_l1_edge_shapes_straddle_the_kernel_tile():
    """The tuple the smoke test also reads: sizes on both sides of kernel
    A's 16 x 64 block tile and of a warp's 16-pixel fragment."""
    assert any(h % 2 and w % 2 for _, h, w in L1_EDGE_SHAPES)
    assert (1, 1, 1) in L1_EDGE_SHAPES
    assert any(h < 16 and w < 64 for _, h, w in L1_EDGE_SHAPES)
    assert any(h % 16 == 1 and w % 64 == 1 for _, h, w in L1_EDGE_SHAPES)
    assert any(h % 16 == 15 and w % 64 == 63 for _, h, w in L1_EDGE_SHAPES)
    assert any(w % 16 == 8 for _, _, w in L1_EDGE_SHAPES)
    assert any(h > 16 and h % 16 == 0 for _, h, _ in L1_EDGE_SHAPES)
    assert TPU_L1_EDGE_SHAPES


@pytest.mark.parametrize("uint8", [True, False])
@pytest.mark.parametrize("shape", L1_EDGE_SHAPES)
def test_kernel_a_plain_edge_shapes_match_numpy(rng, shape, uint8):
    """Kernel A's plain version at the edges of the CUDA kernel's tiling,
    against a float64 conv of the same bf16 operands: zero padding on the
    frame only; the channel sums are those of the stored bf16 values, held
    to 1e-3 of the largest."""
    b, h, w = shape
    x = _frames(rng, (b, h, w, 3), uint8)
    k1 = (rng.normal(size=(b, 32, 28)) * 0.3).astype(np.float32)
    if uint8:   # /255 folded into the tap columns, as stem_l1_weights does
        k1[..., :27] /= 255.0
    a1, sums = stem_l1(torch.from_numpy(x), torch.from_numpy(k1))
    assert a1.shape == (b, h, w, 32) and a1.dtype == torch.bfloat16
    assert sums.shape == (b, 32) and sums.dtype == torch.float32
    xq = torch.from_numpy(x.astype(np.float32)).to(
        torch.bfloat16).double().numpy()
    kq = torch.from_numpy(k1).to(torch.bfloat16).double().numpy()
    xp = np.pad(xq, ((0, 0), (1, 1), (1, 1), (0, 0)))
    patches = np.stack([xp[:, ki:ki + h, kj:kj + w, c]
                        for ki in range(3) for kj in range(3)
                        for c in range(3)], axis=-1)      # (b, h, w, 27)
    acc = np.einsum("bhwt,bot->bhwo", patches, kq[..., :27]) \
        + kq[:, None, None, :, 27]
    want = acc / (1.0 + np.exp(-acc))
    np.testing.assert_allclose(a1.float().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    want_sums = want.sum(axis=(1, 2))
    assert np.abs(sums.numpy() - want_sums).max() \
        <= 1e-3 * max(np.abs(want_sums).max(), 1.0)
    np.testing.assert_allclose(sums.numpy(),
                               a1.double().sum(dim=(1, 2)).numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("uint8", [True, False])
@pytest.mark.parametrize("shape", TPU_L1_EDGE_SHAPES)
def test_kernel_a_plain_edge_shapes_match_pallas_l1(rng, shape, uint8):
    """Where the TPU kernel takes the shape: ``pallas_l1`` in interpret
    mode, its four parity banks put back together."""
    b, h, w = shape
    x = _frames(rng, (b, h, w, 3), uint8)
    k1 = (rng.normal(size=(b, 32, 28)) * 0.05).astype(np.float32)
    banks, sums = pallas_l1(jnp.asarray(x), jnp.asarray(k1), interpret=True)
    want = np.zeros((b, h, w, 32), np.float32)
    for q, bank in enumerate(banks):
        rp, cp = divmod(q, 2)
        want[:, rp::2, cp::2] = np.asarray(
            bank, np.float32)[:, :, :h // 2, :w // 2].transpose(0, 2, 3, 1)
    a1, got_sums = stem_l1_plain(torch.from_numpy(x), torch.from_numpy(k1))
    _assert_bf16_close(a1.float().numpy(), want)
    np.testing.assert_allclose(got_sums.numpy(), np.asarray(sums),
                               rtol=1e-4, atol=1e-3)


def test_kernel_a_wrapper_rules(rng):
    """The kernel's wrapper raises before any launch on shapes and types
    the kernel does not take, whatever the device; a CPU tensor goes to the
    plain version and launches nothing."""
    x = torch.zeros((2, 8, 8, 3), dtype=torch.uint8)
    k1 = torch.zeros((2, 32, 28))
    with pytest.raises(ValueError, match="x"):
        _stem_l1_cuda(torch.zeros((2, 8, 8, 4), dtype=torch.uint8), k1)
    with pytest.raises(ValueError, match="x"):
        _stem_l1_cuda(x.to(torch.int32), k1)
    with pytest.raises(ValueError, match="k1"):
        _stem_l1_cuda(x, k1[:1])
    with pytest.raises(ValueError, match="k1"):
        _stem_l1_cuda(x, k1[:, :, :27])
    with pytest.raises(ValueError, match="k1"):
        _stem_l1_cuda(x, k1.double())
    before = kernels.launch_counts()
    a1, sums = stem_l1(x, k1)
    assert a1.device.type == "cpu" and sums.device.type == "cpu"
    assert kernels.launch_counts() == before
