"""The port's per-sample dynamic conv (uavdet_tpu_torch/ops/dyconv.py)
against the JAX package's ``ops/pallas_dyconv.py``, on the CPU.

The Pallas kernel runs in interpret mode, as ``tests/test_pallas_dyconv.py``
runs it; the port runs its kernel's plain PyTorch version, which a CPU tensor
selects. Inputs come from a numpy seed and are rounded to bf16 the same way
on both sides.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tests.test_pallas_dyconv import _xla_mixed
from uavdet_tpu.ops.fold_soem_neck import runfold
from uavdet_tpu.ops.pallas_dyconv import mixed_bias as jax_mixed_bias
from uavdet_tpu.ops.pallas_dyconv import mixed_kernel as jax_mixed_kernel
from uavdet_tpu.ops.pallas_dyconv import pallas_dyconv
from uavdet_tpu_torch import kernels
from uavdet_tpu_torch.ops.dyconv import (EDGE_SHAPES, _dyconv_cuda, dyconv,
                                         dyconv_plain, gap_fold_order,
                                         gap_plain_order, mixed_bias,
                                         mixed_kernel, parity_sums, rfold)

# the edge shapes the TPU kernel takes as well: C and Co multiples of 128, W
# of 8, H of the strip height 8
TPU_EDGE_SHAPES = tuple(s for s in EDGE_SHAPES if s[3] % 128 == 0
                        and s[4] % 128 == 0 and s[2] % 8 == 0
                        and s[1] % 8 == 0)


def _case(rng, b, h, w, c, co, affine=True):
    """numpy f32 operands of one call, as tests/test_pallas_dyconv.py draws
    them."""
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    k = rng.normal(size=(b, 9, c, co)).astype(np.float32) * 0.1
    if affine:
        mul = rng.uniform(0.5, 1.5, size=(co,)).astype(np.float32)
        add = rng.normal(size=(b, co)).astype(np.float32)
    else:
        mul, add = np.ones((co,), np.float32), np.zeros((b, co), np.float32)
    return x, k, mul, add


def _jax_args(x, k, mul, add):
    return (jnp.asarray(x, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
            jnp.asarray(mul), jnp.asarray(add))


def _torch_args(x, k, mul, add):
    return (torch.from_numpy(x).to(torch.bfloat16),
            torch.from_numpy(k).to(torch.bfloat16), torch.from_numpy(mul),
            torch.from_numpy(add))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def test_mixed_kernel_and_bias_match_jax(rng):
    """f32 on both sides; a sum over E = 3 experts, so only its order can
    differ."""
    c, co, e, b = 16, 8, 3, 4
    stacked = rng.normal(size=(3, 3, c, e * co)).astype(np.float32)
    bias = rng.normal(size=(e * co,)).astype(np.float32)
    attn = rng.dirichlet(np.ones(e), size=b).astype(np.float32)
    got = mixed_kernel(torch.from_numpy(stacked), torch.from_numpy(attn), co)
    want = jax_mixed_kernel(jnp.asarray(stacked), jnp.asarray(attn), co)
    assert got.shape == (b, 9, c, co)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    got = mixed_bias(torch.from_numpy(bias), torch.from_numpy(attn), co)
    want = jax_mixed_bias(jnp.asarray(bias), jnp.asarray(attn), co)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("shape,rs", [((2, 16, 16, 128, 128), 8),
                                      ((1, 32, 8, 256, 128), 16)])
def test_dyconv_plain_matches_pallas_interpret(rng, shape, rs):
    """bf16 operands and f32 sums on both sides; the sums associate
    differently. The tolerance is the JAX test's own."""
    args = _case(rng, *shape)
    want = pallas_dyconv(*_jax_args(*args), rs=rs, interpret=True)
    got = dyconv(*_torch_args(*args))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0.02, atol=0.02)


def test_co64_matches_fold_out_of_pallas(rng):
    """Co = 64: the TPU kernel stores it row-folded only. The port's plain
    store is held against ``runfold`` of that, and the port's ``fold_out``
    store against the JAX folded output directly."""
    args = _case(rng, 2, 16, 16, 128, 64)
    folded = pallas_dyconv(*_jax_args(*args), rs=8, interpret=True,
                           fold_out=True)
    got = dyconv(*_torch_args(*args))
    np.testing.assert_allclose(_f32(got), _f32(runfold(folded)), rtol=0.02,
                               atol=0.02)
    got_f = dyconv(*_torch_args(*args), fold_out=True)
    assert got_f.shape == folded.shape == (2, 8, 16, 128)
    np.testing.assert_allclose(_f32(got_f), _f32(folded), rtol=0.02,
                               atol=0.02)
    # a store mode of one function: the same values, moved
    assert torch.equal(got_f, rfold(got))


@pytest.mark.parametrize("co,fold,h,rs", [(64, True, 8, 4),
                                          (128, False, 16, 8),
                                          (128, True, 16, 8)])
def test_emit_gap_sums_in_both_orders(rng, co, fold, h, rs):
    """The JAX kernel emits per-strip sums in the order of its store mode;
    the port emits (B, 2, 2, Co) [row parity, column parity, c] and gives
    both orders by helpers."""
    args = _case(rng, 2, h, 16, 128, co, affine=False)
    out, gap = pallas_dyconv(*_jax_args(*args), rs=rs, interpret=True,
                             fold_out=fold, emit_gap=True)
    want = np.asarray(gap.sum(axis=1))
    order = gap_fold_order if fold else gap_plain_order

    # the same stored values through the port's sums: only the f32 order of
    # the additions differs
    stored = torch.from_numpy(_f32(runfold(out) if fold else out))
    np.testing.assert_allclose(order(parity_sums(stored)).numpy(), want,
                               rtol=1e-5, atol=1e-4)

    # the port's own call. Its output differs from the JAX kernel's by a
    # bf16 ulp (2^-8 relative, values up to ~4) in a few elements per
    # thousand, and each such element moves a sum of 32-64 values by that
    # much: a handful of ulps of slack, no more.
    got_out, sums = dyconv(*_torch_args(*args), fold_out=fold, emit_gap=True)
    assert sums.shape == (2, 2, 2, co) and sums.dtype == torch.float32
    np.testing.assert_allclose(_f32(got_out), _f32(out), rtol=0.02, atol=0.02)
    np.testing.assert_allclose(order(sums).numpy(), want, rtol=1e-3,
                               atol=0.1)
    # and the sums are of the stored values, whatever the store mode
    unfolded = dyconv(*_torch_args(*args))
    np.testing.assert_allclose(sums.numpy(), parity_sums(unfolded).numpy(),
                               rtol=1e-6, atol=1e-5)


def test_emit_gap_leaves_the_output_as_it_is(rng):
    args = _torch_args(*_case(rng, 2, 8, 16, 16, 8))
    out, _ = dyconv(*args, emit_gap=True)
    assert torch.equal(out, dyconv(*args))


def test_shapes_the_tpu_kernel_refused(rng):
    """Any H and W, C and Co multiples of 8: (2, 37, 50, 24) -> 40 against
    the XLA mixed-kernel conv the JAX test uses as its reference."""
    args = _case(rng, 2, 37, 50, 24, 40)
    want = _xla_mixed(*_jax_args(*args))
    got, sums = dyconv(*_torch_args(*args), emit_gap=True)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0.02, atol=0.02)
    np.testing.assert_allclose(sums.numpy(), parity_sums(got).numpy(),
                               rtol=1e-6, atol=1e-5)


def test_dispatch_and_rejections(rng):
    x, k, mul, add = _torch_args(*_case(rng, 1, 8, 8, 16, 8))
    before = kernels.launch_counts()["dyconv"]
    assert torch.equal(dyconv(x, k, mul, add), dyconv_plain(x, k, mul, add))
    assert kernels.launch_counts()["dyconv"] == before   # CPU: no launch
    with pytest.raises(ValueError, match="no dyconv kernel"):
        dyconv(x.to("meta"), k, mul, add)
    with pytest.raises(ValueError, match="k must be"):
        dyconv(x, k[:, :8], mul, add)
    with pytest.raises(ValueError, match="add"):
        dyconv(x, k, mul, add[:, :4])
    with pytest.raises(ValueError, match="even H"):
        dyconv(x[:, :7], k, mul, add, fold_out=True)


def _conv_f64(x, k, mul, add):
    """SiLU(conv3x3 SAME(x[b], k[b]) * mul + add[b]) in float64 numpy on the
    bf16-rounded operands; zero padding on x only."""
    xq = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
    kq = torch.from_numpy(k).to(torch.bfloat16).double().numpy()
    _, h, w, _ = x.shape
    xp = np.pad(xq, ((0, 0), (1, 1), (1, 1), (0, 0)))
    acc = sum(np.einsum("bhwc,bco->bhwo", xp[:, dy:dy + h, dx:dx + w],
                        kq[:, 3 * dy + dx])
              for dy in range(3) for dx in range(3))
    y = acc * mul.astype(np.float64) + add.astype(np.float64)[:, None, None]
    return y / (1.0 + np.exp(-y))


def test_edge_shapes_straddle_the_kernel_tiles():
    """The tuple the smoke test also reads: H * W off the 16 x 16 pixel tile,
    C off the 16-channel chunk, Co at 8, 64, 72, 136 and 264."""
    assert {s[4] for s in EDGE_SHAPES} >= {8, 64, 72, 136, 264}
    assert any(s[1] % 16 and s[2] % 16 for s in EDGE_SHAPES)
    assert any(s[3] % 16 for s in EDGE_SHAPES)
    assert any(s[3] < 16 for s in EDGE_SHAPES)
    assert all(s[3] % 8 == 0 and s[4] % 8 == 0 for s in EDGE_SHAPES)
    assert TPU_EDGE_SHAPES


@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_dyconv_plain_edge_shapes_match_numpy(rng, shape):
    """The plain version at the edges of the CUDA kernel's tiling, against a
    float64 conv: one bf16 ulp plus margin on the store; the sums, which add
    the stored values, within 1e-3 of the largest sum."""
    args = _case(rng, *shape)
    want = _conv_f64(*args)
    got, sums = dyconv(*_torch_args(*args), emit_gap=True)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_f32(got), want, rtol=1.6e-2, atol=1e-2)
    stored = torch.from_numpy(want).to(torch.bfloat16)
    want_sums = parity_sums(stored).double().numpy()
    assert sums.shape == (shape[0], 2, 2, shape[4])
    assert np.abs(sums.double().numpy() - want_sums).max() \
        <= 1e-3 * np.abs(want_sums).max()
    if shape[1] % 2 == 0:
        assert torch.equal(dyconv(*_torch_args(*args), fold_out=True),
                           rfold(got))


@pytest.mark.parametrize("shape", TPU_EDGE_SHAPES)
def test_dyconv_plain_edge_shapes_match_pallas_where_taken(rng, shape):
    args = _case(rng, *shape)
    want = pallas_dyconv(*_jax_args(*args), rs=8, interpret=True)
    got = dyconv(*_torch_args(*args))
    assert got.shape == want.shape
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0.02, atol=0.02)


@pytest.mark.parametrize("c,co", [(12, 8), (8, 12), (20, 36)])
def test_kernel_wrapper_takes_multiples_of_8_only(rng, c, co):
    """The kernel reads 16-byte vectors: its wrapper raises before any
    launch for other channel counts, whatever the device."""
    x, k, mul, add = _torch_args(*_case(rng, 1, 4, 4, c, co))
    before = kernels.launch_counts()["dyconv"]
    with pytest.raises(ValueError, match="multiples of 8"):
        _dyconv_cuda(x, k, mul, add, False, False)
    assert kernels.launch_counts()["dyconv"] == before


def test_kernel_wrapper_takes_contiguous_bf16_only(rng):
    x, k, mul, add = _torch_args(*_case(rng, 1, 4, 4, 8, 8))
    with pytest.raises(ValueError, match="contiguous bf16"):
        _dyconv_cuda(x.float(), k, mul, add, False, False)
    with pytest.raises(ValueError, match="contiguous bf16"):
        _dyconv_cuda(x.transpose(1, 2), k, mul, add, False, False)
