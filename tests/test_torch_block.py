"""The port's fused post-stem block (uavdet_tpu_torch/ops/block.py, kernel
G) against the JAX package: the flax ``ResidualBlock`` + ``CNNBlock`` it
fuses, and the TPU kernel of ``scripts/block_ablate.py`` in interpret mode.

On the CPU ``post_stem_block`` runs its plain version: three f32 convs on
bf16-rounded operands, the two inner activations rounded to bf16, the
residual added in f32 after the leaky.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_model import STEM_CFG, TINY_CFG
from uavdet_tpu.models.layers import CNNBlock as JaxCNNBlock
from uavdet_tpu.models.layers import ResidualBlock as JaxResidualBlock
from uavdet_tpu.utils.torch_import import import_interpreter_state_dict
from uavdet_tpu_torch.models import BASELINE, BaselineModel, DyYOLO
from uavdet_tpu_torch.ops.block import (BLOCK_EDGE_SHAPES, BLOCK_STAGES,
                                        PackedConv, _post_stem_block_cuda,
                                        fold_block_weights,
                                        fold_cnnblock, pack_block_weights,
                                        post_stem_block,
                                        post_stem_block_plain,
                                        post_stem_block_stage, sw64_image)
from uavdet_tpu_torch.scripts import block_ablate, l2_ablate
from uavdet_tpu_torch.utils.seeding import init_weights

REPO = Path(__file__).resolve().parents[1]


def _bf16_representable(model):
    """Weights that bf16 holds exactly, so that both sides read the same
    values (the block rounds its operands to bf16)."""
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            if t.is_floating_point():
                t.copy_(t.to(torch.bfloat16).float())
    return model


@pytest.fixture(scope="module")
def stem_model():
    return _bf16_representable(
        init_weights(DyYOLO(STEM_CFG, attn_temperature=30.0), 3).eval())


def _frames(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("shape", [(2, 16, 24, 64), (1, 9, 13, 64)])
def test_block_matches_flax_layers(rng, stem_model, shape):
    """Against flax's ResidualBlock(64) + CNNBlock(128, 3x3, s2) in f32 with
    bridged weights, even and odd sizes. The block folds BN into bf16
    weights and rounds z and y to bf16; flax keeps f32: rtol 0.05, atol 0.05
    on values of a few units, the bound of the bf16 DySOEM test."""
    params, stats = (tree["net"] for tree in import_interpreter_state_dict(
        {k: v.numpy() for k, v in stem_model.state_dict().items()}, STEM_CFG))
    x = _frames(rng, shape)
    xj = jnp.asarray(x.float().numpy())
    y = JaxResidualBlock(64, num_repeats=1).apply(
        {"params": params["ResidualBlock_0"],
         "batch_stats": stats["ResidualBlock_0"]}, xj, False)
    want = np.asarray(JaxCNNBlock(128, (3, 3), (2, 2), 1).apply(
        {"params": params["CNNBlock_0"], "batch_stats": stats["CNNBlock_0"]},
        y, False))
    got = post_stem_block(x, *fold_block_weights(stem_model))
    assert got.dtype == torch.bfloat16
    assert got.shape == (shape[0], (shape[1] + 1) // 2, (shape[2] + 1) // 2,
                         128)
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05)
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.9999


def _flax_block(stem_model, x):
    """flax's ResidualBlock(64) + CNNBlock(128, 3x3, s2), f32, with the
    model's weights bridged, on bf16 frames x."""
    params, stats = (tree["net"] for tree in import_interpreter_state_dict(
        {k: v.numpy() for k, v in stem_model.state_dict().items()}, STEM_CFG))
    y = JaxResidualBlock(64, num_repeats=1).apply(
        {"params": params["ResidualBlock_0"],
         "batch_stats": stats["ResidualBlock_0"]},
        jnp.asarray(x.float().numpy()), False)
    return np.asarray(JaxCNNBlock(128, (3, 3), (2, 2), 1).apply(
        {"params": params["CNNBlock_0"], "batch_stats": stats["CNNBlock_0"]},
        y, False))


@pytest.mark.parametrize("shape", BLOCK_EDGE_SHAPES,
                         ids=["-".join(map(str, s)) for s in BLOCK_EDGE_SHAPES])
def test_block_edge_shapes_match_flax_layers(rng, stem_model, shape):
    """The plain version at every shape the smoke test also holds the
    kernel to (sizes off its 8 x 8 output tile, one pixel, H = 2, W = 1, a
    part-full last round of its persistent grid, odd batches), packed once,
    against the flax layers: the tolerance of the test above."""
    x = _frames(rng, (*shape, 64))
    want = _flax_block(stem_model, x)
    got = post_stem_block(x, *pack_block_weights(
        *fold_block_weights(stem_model)))
    b, h, w = shape
    assert got.shape == (b, (h + 1) // 2, (w + 1) // 2, 128) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0.05,
                               atol=0.05)


def test_block_edge_shapes_straddle_the_kernel_layout():
    """The tuple the smoke test also reads: H and W off the 16 input pixels
    of a tile, one pixel, H = 2, W = 1, an odd batch, and a tile count that
    leaves the grid's last round (at most 66 clusters) part-full."""
    hs = [h for _, h, _ in BLOCK_EDGE_SHAPES]
    ws = [w for _, _, w in BLOCK_EDGE_SHAPES]
    assert (1, 1, 1) in BLOCK_EDGE_SHAPES and 2 in hs and 1 in ws
    assert any(h % 16 and w % 16 for _, h, w in BLOCK_EDGE_SHAPES)
    assert any(b % 2 for b, _, _ in BLOCK_EDGE_SHAPES)
    tiles = [b * -(-((h + 1) // 2) // 8) * -(-((w + 1) // 2) // 8)
             for b, h, w in BLOCK_EDGE_SHAPES]
    assert any(t > 2 * 66 and t % 66 for t in tiles)


def test_sw64_image_is_the_swizzled_layout(rng):
    """Element (k, n) of a (K, 32) matrix lands at byte (k // 8) * 512 +
    (k % 8) * 64 + ((n // 8) ^ ((k % 8) // 2)) * 16 + (n % 8) * 2: the
    64-byte swizzle of 8-row atoms that ``csrc/wgmma.cuh`` describes."""
    kn = torch.from_numpy(rng.normal(size=(24, 32)).astype(np.float32))
    image = sw64_image(kn).numpy()
    for k in range(24):
        for n in range(32):
            at = ((k // 8) * 512 + (k % 8) * 64
                  + ((n // 8) ^ ((k % 8) // 2)) * 16 + (n % 8) * 2) // 2
            assert image[at] == kn[k, n]
    assert sorted(image.tolist()) == sorted(kn.flatten().tolist())


def test_packed_weights_are_the_matrices_form(rng, stem_model):
    """``pack_block_weights``: the operands split over the two blocks of a
    cluster as the kernel reads them (k2 by output channel, k3 by input
    channel), and ``post_stem_block`` on them bitwise what it gives on the
    (O, K + 1) matrices."""
    ws = fold_block_weights(stem_model)
    packed = pack_block_weights(*ws)
    assert all(isinstance(p, PackedConv) for p in packed)
    assert [tuple(p.image.shape) for p in packed] == [(2048,), (2, 9216),
                                                      (2, 36864)]
    assert [tuple(p.bias.shape) for p in packed] == [(32,), (2, 32), (2, 64)]
    assert all(p.image.dtype == torch.bfloat16 and p.bias.dtype
               == torch.float32 for p in packed)
    # rank r of k3 holds the K rows of y's channels [32 r, 32 r + 32) of
    # every tap, for the 128 outputs in four slices of 32; its bias the 64
    # output channels the block finishes
    k3q = ws[2].to(torch.bfloat16)
    for r in range(2):
        rows = [tap * 64 + 32 * r + c for tap in range(9) for c in range(32)]
        for s in range(4):
            assert torch.equal(packed[2].image[r, 9216 * s:9216 * (s + 1)],
                               sw64_image(k3q[32 * s:32 * s + 32, rows].t()))
        assert torch.equal(packed[2].bias[r], k3q[64 * r:64 * r + 64,
                                                  -1].float())
    k2q = ws[1].to(torch.bfloat16)
    for r in range(2):
        assert torch.equal(packed[1].image[r],
                           sw64_image(k2q[32 * r:32 * r + 32, :-1].t()))
    x = _frames(rng, (2, 11, 19, 64))
    assert torch.equal(post_stem_block(x, *packed), post_stem_block(x, *ws))
    assert torch.equal(post_stem_block_stage(x, *packed, "full"),
                       post_stem_block_plain(x, *ws))


def test_block_kernel_wrapper_rules(rng, stem_model):
    """The kernel's wrapper raises before any launch on operands the kernel
    does not take: x of another width or dtype, a matrix of another shape,
    packed operands of another shape or dtype."""
    ws = fold_block_weights(stem_model)
    packed = pack_block_weights(*ws)
    x = _frames(rng, (1, 8, 8, 64))
    with pytest.raises(ValueError, match="bfloat16"):
        _post_stem_block_cuda(x.float(), *packed, 3)
    with pytest.raises(ValueError, match=r"\(64, 289\)"):
        _post_stem_block_cuda(x, ws[0], ws[1][:, 1:], ws[2], 3)
    short = packed[2]._replace(image=packed[2].image[:, 1:])
    with pytest.raises(ValueError, match=r"k3: packed operands must be "
                                         r"\(2, 36864\) bfloat16"):
        _post_stem_block_cuda(x, packed[0], packed[1], short, 3)
    wide = packed[0]._replace(bias=packed[0].bias.double())
    with pytest.raises(ValueError, match="w1: packed operands"):
        _post_stem_block_cuda(x, wide, packed[1], packed[2], 3)


def test_block_matches_the_models_own_layers(rng, stem_model):
    """The same two tokens as the port's eager tail runs them (f32)."""
    x = _frames(rng, (2, 12, 20, 64))
    with torch.no_grad():
        i = stem_model.first_layer[2]
        want = stem_model.layers[i + 1](stem_model.layers[i](
            x.float().permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
    got = post_stem_block_plain(x, *fold_block_weights(stem_model)).float()
    torch.testing.assert_close(got, want, rtol=0.05, atol=0.05)


def test_block_matches_tpu_kernel_interpret(rng):
    """Against ``build_kernel(..., "full")`` of scripts/block_ablate.py, run
    through ``pl.pallas_call(interpret=True)`` with ``run_variant``'s specs,
    on the operands of the script's ``main`` at 64 px (two strips of 16
    rows). The TPU kernel rounds its last sum to bf16 before the leaky (it
    goes through the selection product), the port after it: one bf16 ulp on
    negative outputs, inside rtol 1.6e-2, atol 1e-2."""
    spec = importlib.util.spec_from_file_location(
        "tpu_block_ablate", REPO / "scripts" / "block_ablate.py")
    tpu = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tpu)
    b, h2, w, tro = 1, 32, 32, 8
    wp, hp = 128, h2 + 8
    x = rng.normal(size=(b, 64, hp, wp)).astype(np.float32)
    x[:, :, h2:, :] = 0.0
    x[:, :, :, w:] = 0.0
    x_cm = jnp.asarray(x, jnp.bfloat16)
    w1, k2, k3 = (jnp.asarray(rng.normal(size=s) * 0.1, jnp.bfloat16)
                  for s in ((32, 65), (64, 289), (128, 577)))
    f = -(-(2 * tro + 2) // 8) * 8
    ny = 2 * tro + 2

    def vmem(shape):
        return pl.BlockSpec(shape, lambda bi, si: (0, 0),
                            memory_space=pltpu.VMEM)

    out = pl.pallas_call(
        tpu.build_kernel(w, h2, wp, tro, "full"),
        grid=(b, h2 // (2 * tro)),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY), vmem((32, 65)),
                  vmem((64, 289)), vmem((128, 577))],
        out_specs=pl.BlockSpec((1, 128, tro, w // 2),
                               lambda bi, si: (bi, 0, si, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((b, 128, h2 // 2, w // 2),
                                       jnp.bfloat16),
        scratch_shapes=[
            pltpu.VMEM((289, ny, wp), jnp.bfloat16),
            pltpu.VMEM((1, 64, ny // 2, 2 * wp), jnp.bfloat16),
            pltpu.VMEM((577, tro, wp), jnp.bfloat16),
            pltpu.VMEM((2, 64, f + 8, wp), jnp.bfloat16),
            pltpu.VMEM((64, f + 8, wp), jnp.bfloat16),
            pltpu.SemaphoreType.DMA((2,)),
        ],
        interpret=True)(x_cm, w1, k2, k3)
    want = np.asarray(out, np.float32).transpose(0, 2, 3, 1)

    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    xt = t(x_cm[:, :, :h2, :w]).permute(0, 2, 3, 1).to(torch.bfloat16)
    got = post_stem_block_plain(xt, t(w1), t(k2), t(k3)).float().numpy()
    assert got.shape == want.shape == (b, h2 // 2, w // 2, 128)
    np.testing.assert_allclose(got, want, rtol=1.6e-2, atol=1e-2)
    assert (got == want).mean() > 0.8


def test_block_inner_activations_are_zero_outside_the_image(rng):
    """With biases of the activations' size, padding z or y with
    leaky(bias) instead of zero would move every border output: held
    against a float64 numpy conv of the same bf16 operands."""
    x = _frames(rng, (1, 6, 7, 64))
    ws = [torch.from_numpy((rng.normal(size=s) * 0.1).astype(np.float32))
          for s in ((32, 65), (64, 289), (128, 577))]
    for k, v in zip(ws, (1.0, -1.5, 0.5)):
        k[:, -1] = v
    got = post_stem_block_plain(x, *ws).float().numpy()[0]

    def q(t):
        return t.to(torch.bfloat16).double().numpy()

    def conv(a, k, ksize, stride):
        """a (H, W, C) f64, k (O, k*k*C + 1): zero padding on a only."""
        p = ksize // 2
        ap = np.pad(a, ((p, p), (p, p), (0, 0)))
        h, w, _ = a.shape
        cols = np.concatenate(
            [ap[i:i + h:stride, j:j + w:stride] for i in range(ksize)
             for j in range(ksize)], axis=-1)
        v = cols @ k[:, :-1].T + k[:, -1]
        return np.maximum(v, 0.1 * v)

    def bf16(a):
        return torch.from_numpy(a).to(torch.bfloat16).double().numpy()

    xq = q(x)[0]
    z = bf16(conv(xq, q(ws[0]), 1, 1))
    y = bf16(conv(z, q(ws[1]), 3, 1) + xq)
    want = conv(y, q(ws[2]), 3, 2)
    np.testing.assert_allclose(got, want, rtol=1.6e-2, atol=1e-2)


@pytest.mark.parametrize("name", ["stem", "baseline"])
def test_fold_block_weights(rng, stem_model, name):
    """Shapes, and each folded matrix against its own CNNBlock in f32."""
    if name == "stem":
        model = stem_model
    else:
        model = init_weights(BaselineModel(BASELINE.layer_config), 4).eval()
    w1, k2, k3 = fold_block_weights(model)
    assert (w1.shape, k2.shape, k3.shape) == ((32, 65), (64, 289),
                                              (128, 577))
    i = model.first_layer[2]
    block = model.layers[i + 1]
    x = torch.from_numpy(rng.normal(size=(1, 64, 8, 8)).astype(np.float32))
    weight = k3[:, :-1].reshape(128, 3, 3, 64).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = torch.nn.functional.leaky_relu(torch.nn.functional.conv2d(
            x, weight, k3[:, -1], stride=2, padding=1), 0.1)
        torch.testing.assert_close(got, block(x), rtol=1e-4, atol=1e-4)
        assert torch.equal(fold_cnnblock(block), k3)


def test_fold_block_weights_needs_the_pair():
    narrow = DyYOLO(((16, 3, 1), ("B", 1), (128, 3, 2), ("S",)))
    with pytest.raises(ValueError, match="64 channels"):
        fold_block_weights(narrow)
    for model in (DyYOLO(TINY_CFG), torch.nn.Linear(2, 2)):
        with pytest.raises(ValueError, match="layer_config"):
            fold_block_weights(model)


@pytest.mark.parametrize("stage", BLOCK_STAGES)
def test_block_stage_on_cpu(rng, stem_model, stage):
    """Only the ladder's last stage is the block; the dispatch rule."""
    x = _frames(rng, (1, 8, 8, 64))
    ws = fold_block_weights(stem_model)
    if stage == "full":
        assert torch.equal(post_stem_block_stage(x, *ws, stage),
                           post_stem_block_plain(x, *ws))
    else:
        with pytest.raises(ValueError, match="only as a CUDA kernel"):
            post_stem_block_stage(x, *ws, stage)
    with pytest.raises(ValueError, match="no block kernel"):
        post_stem_block_stage(x.to("meta"), *(w.to("meta") for w in ws),
                              stage)


@pytest.mark.parametrize("script", [l2_ablate, block_ablate],
                         ids=["l2_ablate", "block_ablate"])
def test_ladder_scripts_without_a_gpu(script, capsys):
    """The entry points import without a GPU, ``--help`` works and names the
    original's arguments, and a run without a card exits non-zero."""
    with pytest.raises(SystemExit) as e:
        script.main(["--help"])
    assert e.value.code == 0
    text = capsys.readouterr().out
    for arg in ("--batch", "--input", "--iters"):
        assert arg in text
    assert ("--stages" if script is l2_ablate else "--only") in text
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="needs a CUDA device"):
            script.main([])
