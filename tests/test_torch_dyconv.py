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
from uavdet_tpu_torch.ops.dyconv import (dyconv, dyconv_plain, gap_fold_order,
                                         gap_plain_order, mixed_bias,
                                         mixed_kernel, parity_sums, rfold)


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
