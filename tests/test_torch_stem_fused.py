"""The port's fused stem op (uavdet_tpu_torch/ops/stem.py:stem_fused, kernel
E) against the JAX package's ``pallas_dyconv_stem`` in interpret mode, and
the dispatch rule of kernel B's stage ladder.

On the CPU ``stem_fused`` runs its plain version, kernel B's plain version
of kernel A's. Both sides round the same operands to bf16, keep the first
activation in bf16 and accumulate in f32; only the order of the f32 sums
differs, which moves a result across a bf16 rounding boundary rarely (one
ulp, 2^-8 relative), and a flipped first-layer value moves a second-layer
sum a little further. Hence: all elements within rtol 1.6e-2, atol 1e-2, and
at least 99 % bitwise equal.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from uavdet_tpu.ops.pallas_stem import mix_and_fold as jax_mix_and_fold
from uavdet_tpu.ops.pallas_stem import pallas_dyconv_stem
from uavdet_tpu_torch.ops.stem import (L1_EDGE_SHAPES, L2_STAGES, stem_fused,
                                       stem_fused_plain, stem_l1,
                                       stem_l1_plain, stem_l2, stem_l2_plain,
                                       stem_l2_stage)

RTOL, ATOL, MIN_EQUAL = 1.6e-2, 1e-2, 0.99


def _case(rng, b, h, w):
    """The operands of tests/test_pallas_stem.py: frames in [0, 1], expert
    kernels, softmax attention, perturbed BN -> (x, K1, K2) as numpy."""
    x = rng.uniform(size=(b, h, w, 3)).astype(np.float32)
    ks = []
    for i_ch, o_ch, std in ((3, 32, 0.2), (32, 64, 0.05)):
        experts = (rng.normal(size=(3, 3, i_ch, 4 * o_ch)) * std).astype(
            np.float32)
        attn = jax.nn.softmax(jnp.asarray(
            rng.normal(size=(b, 4)).astype(np.float32)), -1)
        bn = [jnp.asarray(v.astype(np.float32)) for v in (
            rng.uniform(0.5, 1.5, o_ch), rng.normal(size=o_ch) * 0.1,
            rng.normal(size=o_ch) * 0.1, rng.uniform(0.5, 1.5, o_ch))]
        ks.append(np.array(jax_mix_and_fold(
            jnp.asarray(experts), attn, *bn, out_channels=o_ch)))
    return x, ks[0], ks[1]


def _both(x, k1, k2):
    want = np.asarray(pallas_dyconv_stem(
        jnp.asarray(x), jnp.asarray(k1), jnp.asarray(k2), tr2=8,
        interpret=True), np.float32)
    got = stem_fused_plain(torch.from_numpy(x), torch.from_numpy(k1),
                           torch.from_numpy(k2))
    assert got.dtype == torch.bfloat16
    return got.float().numpy(), want


@pytest.mark.parametrize("b,h,w", [(2, 64, 64), (1, 32, 32)])
def test_stem_fused_plain_matches_pallas_stem(rng, b, h, w):
    got, want = _both(*_case(rng, b, h, w))
    assert got.shape == want.shape == (b, h // 2, w // 2, 64)
    assert (got == want).mean() >= MIN_EQUAL, (got == want).mean()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_stem_fused_plain_edges_see_zero_padding(rng):
    """The first and last output rows and columns read first-layer pixels
    outside the image, which are 0 for the second layer, not SiLU(bias)."""
    got, want = _both(*_case(rng, 1, 32, 32))
    for edge in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
        np.testing.assert_allclose(got[edge], want[edge], rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("uint8", [True, False])
def test_stem_fused_on_cpu_is_kernel_b_of_kernel_a(rng, uint8):
    """The dispatch rule: a CPU tensor takes the plain versions, so the op
    equals the two-pass stem on the same operands, bitwise; odd sizes."""
    x = (rng.uniform(size=(2, 9, 13, 3)) * 255).astype(np.uint8)
    x = torch.from_numpy(x if uint8 else x.astype(np.float32) / 255.0)
    k1 = torch.from_numpy(rng.normal(size=(2, 32, 28)).astype(np.float32))
    k1 = k1 * (0.3 / 255.0 if uint8 else 0.3)
    k2 = torch.from_numpy(
        (rng.normal(size=(2, 64, 289)) * 0.05).astype(np.float32))
    got = stem_fused(x, k1, k2)
    assert got.shape == (2, 5, 7, 64) and got.dtype == torch.bfloat16
    assert torch.equal(got, stem_l2(stem_l1(x, k1)[0], k2))
    assert torch.isfinite(got.float()).all()


def test_stem_fused_rejects_other_devices():
    x = torch.empty((1, 8, 8, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no stem kernel"):
        stem_fused(x, torch.empty((1, 32, 28), device="meta"),
                   torch.empty((1, 64, 289), device="meta"))


@pytest.mark.parametrize("stage", L2_STAGES)
def test_stem_l2_stage_on_cpu(rng, stage):
    """Only the ladder's last stage is the layer: on the CPU it is kernel
    B's plain version; a cut-off stage has no plain version and raises."""
    a1 = torch.from_numpy(rng.normal(size=(1, 8, 10, 32)).astype(
        np.float32)).to(torch.bfloat16)
    k2 = torch.from_numpy(
        (rng.normal(size=(1, 64, 289)) * 0.05).astype(np.float32))
    if stage == "full":
        assert torch.equal(stem_l2_stage(a1, k2, stage),
                           stem_l2_plain(a1, k2))
    else:
        with pytest.raises(ValueError, match="only as a CUDA kernel"):
            stem_l2_stage(a1, k2, stage)
    with pytest.raises(ValueError, match="no stem kernel"):
        stem_l2_stage(a1.to("meta"), k2.to("meta"), stage)


def test_stem_l2_stage_rejects_unknown_stage():
    with pytest.raises(ValueError):
        stem_l2_stage(torch.empty((1, 8, 8, 32), dtype=torch.bfloat16),
                      torch.empty((1, 64, 289)), "+rolls")


def test_l2_stages_match_the_ladder_script():
    """Every stage of the ladder has a label in the command-line entry that
    times it, and ``full`` (kernel B itself) is last."""
    import inspect

    from uavdet_tpu_torch.scripts import l2_ablate
    assert L2_STAGES[-1] == "full" and len(set(L2_STAGES)) == len(L2_STAGES)
    src = inspect.getsource(l2_ablate)
    for i, stage in enumerate(L2_STAGES):
        assert f'"{stage}": ' in src, stage
        assert f"  {i} {stage} " in l2_ablate.__doc__, stage


@pytest.mark.parametrize("b,h,w", [(1, 33, 35), (2, 9, 13), (1, 31, 65)])
def test_stem_fused_plain_odd_shapes_match_numpy(rng, b, h, w):
    """Both layers at sizes off the kernels' 16 x 16 output tile, against a
    float64 conv pair with the first activation rounded to bf16 in between
    and zero (not SiLU(bias)) outside the image."""
    x, k1, k2 = _case(rng, b, h, w)
    got = stem_fused(torch.from_numpy(x), torch.from_numpy(k1),
                     torch.from_numpy(k2)).float().numpy()

    def q(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(
            torch.bfloat16).double().numpy()

    def conv(a, k, stride):
        ho, wo = -(-a.shape[1] // stride), -(-a.shape[2] // stride)
        ap = np.pad(a, ((0, 0), (1, 2), (1, 2), (0, 0)))
        patches = np.concatenate(
            [ap[:, ki:ki + stride * ho:stride, kj:kj + stride * wo:stride]
             for ki in range(3) for kj in range(3)], axis=-1)
        acc = np.einsum("bhwt,bot->bhwo", patches, k[..., :-1]) \
            + k[:, None, None, :, -1]
        return acc / (1.0 + np.exp(-acc))

    want = conv(q(conv(q(x), q(k1), 1)), q(k2), 2)
    assert got.shape == want.shape == (b, (h + 1) // 2, (w + 1) // 2, 64)
    # a first-layer value that rounds the other way moves a second-layer
    # sum by 2^-8 of one product: far inside the store's tolerance
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", L1_EDGE_SHAPES)
def test_stem_fused_plain_is_plain_b_of_plain_a_at_l1_edge_shapes(rng, shape):
    """At the edges of kernel A's tiling the fused op's plain version is
    kernel B's plain version of kernel A's, bitwise, uint8 frames with /255
    folded into K1: the identity the card holds the fused kernel to."""
    b, h, w = shape
    x = torch.from_numpy((rng.uniform(size=(b, h, w, 3)) * 255).astype(
        np.uint8))
    k1 = torch.from_numpy(rng.normal(size=(b, 32, 28)).astype(np.float32))
    k1 = torch.cat([k1[..., :-1] * (0.3 / 255.0), k1[..., -1:] * 0.3], dim=-1)
    k2 = torch.from_numpy(
        (rng.normal(size=(b, 64, 289)) * 0.05).astype(np.float32))
    got = stem_fused_plain(x, k1, k2)
    a1, _ = stem_l1_plain(x, k1)
    assert got.shape == (b, (h + 1) // 2, (w + 1) // 2, 64)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, stem_l2_plain(a1, k2))
    assert torch.equal(got, stem_fused(x, k1, k2))
    assert torch.isfinite(got.float()).all() and bool((got != 0).any())
