"""The post-stem block of the Darknet tail as one kernel.

Port of the TPU kernel of ``scripts/block_ablate.py`` (``build_kernel`` /
``run_variant``; the JAX package's former "kernel C"): the ``("B", 1)``
ResidualBlock at 64 channels and the ``(128, 3, 2)`` downsample behind it,
with inference BatchNorm folded into the weights:

  z   = leaky(conv1x1(x, w1))           64 -> 32
  y   = leaky(conv3x3(z, k2)) + x       32 -> 64, the residual
  out = leaky(conv3x3 s2(y, k3))        64 -> 128

x is NHWC bf16 (B, H, W, 64), out NHWC bf16 (B, ceil(H/2), ceil(W/2), 128).
The weights are shared by the batch: w1 (32, 65), k2 (64, 289), k3
(128, 577), each with its taps ordered ki-major, then kj, then channel, and
the folded bias as the last column (``mix_and_fold``'s order). Operands are
rounded to bf16, sums are f32, z and y are rounded to bf16 before the next
conv reads them, and the residual is added in f32 after the leaky. Each
conv pads its own input with zeros, so z and y outside the image are 0, not
leaky(bias).

``post_stem_block`` dispatches on the device of x: a CPU tensor takes the
plain PyTorch version, a CUDA tensor launches kernel G
(``csrc/post_stem_block.cu``), anything else raises. As in the JAX package,
no detector calls it: the models' tails keep their own layers.
``post_stem_block_stage`` launches the kernel cut off after one stage of its
ladder (see ``uavdet_tpu_torch/scripts/block_ablate.py``).

The kernel reads each weight matrix as an image of its shared memory
(``pack_block_weights``): a caller that packs once launches kernel G and
nothing else per call; one that passes the (O, K + 1) matrices has them
packed at every call.
"""

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import kernels

_BF16 = torch.bfloat16
LEAKY_SLOPE = 0.1
# The kernel's stage ladder: each stage adds one step to the one before it.
BLOCK_STAGES = ("load", "dot1", "dot2", "full")
BLOCK_TOKENS = (("B", 1), (128, 3, 2))
# (B, H, W) of x at the edges of the kernel's layout: 8 x 8 output tiles (16
# x 16 input pixels under a 19 x 19 window), a persistent grid of clusters of
# two that walk the tiles in turn (at most 66 clusters on an H100). The CPU
# tests hold the plain version against the flax layers at these shapes, the
# smoke test the kernel against the plain version on the card.
BLOCK_EDGE_SHAPES = (
    (2, 37, 45),     # H and W not multiples of the 16-pixel tile
    (1, 1, 1),       # one pixel: every tap but the centre is padding
    (3, 2, 40),      # H = 2, and an odd batch
    (1, 33, 1),      # W = 1
    (1, 176, 200),   # 143 tiles: the grid's third round is part-full
    (5, 20, 18),     # an odd batch of small images, tiles that end mid-image
)


def fold_cnnblock(block) -> torch.Tensor:
    """A ``CNNBlock``'s conv with its inference BatchNorm folded in ->
    (O, k*k*I + 1) f32: taps ki-major, then kj, then channel, and the bias
    as the last column."""
    conv, bn = block.conv, block.bn
    o = conv.weight.shape[0]
    taps = conv.weight.float().permute(0, 2, 3, 1).reshape(o, -1)
    inv = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
    bias = bn.bias.float() - bn.running_mean.float() * inv
    if conv.bias is not None:
        bias = bias + conv.bias.float() * inv
    return torch.cat([taps * inv[:, None], bias[:, None]], dim=1)


def fold_block_weights(model):
    """(w1, k2, k3) of a model whose ``layer_config`` holds the ``("B", 1)``,
    ``(128, 3, 2)`` pair at 64 channels (DyYOLO's and BaselineModel's tokens 2
    and 3)."""
    tokens = tuple(getattr(model, "tokens", ()))
    at = [i for i in range(len(tokens) - 1)
          if tokens[i:i + 2] == BLOCK_TOKENS]
    if not at:
        raise ValueError(f"no {BLOCK_TOKENS} pair in the model's layer_config")
    res = model.layers[model.first_layer[at[0]]]
    down = model.layers[model.first_layer[at[0] + 1]]
    if res.layers[0][0].conv.weight.shape[:2] != (32, 64):
        raise ValueError("the block kernel takes the pair at 64 channels")
    return (fold_cnnblock(res.layers[0][0]), fold_cnnblock(res.layers[0][1]),
            fold_cnnblock(down))


def _conv(x_nchw, k_aug, ksize, stride):
    """leaky(conv(x, K) + bias) in f32, from bf16-rounded K (O, k*k*I + 1)."""
    o = k_aug.shape[0]
    k = k_aug.to(_BF16).float()
    weight = k[:, :-1].reshape(o, ksize, ksize, -1).permute(0, 3, 1, 2)
    return F.leaky_relu(F.conv2d(x_nchw, weight, k[:, -1], stride=stride,
                                 padding=ksize // 2), LEAKY_SLOPE)


def post_stem_block_plain(x: torch.Tensor, w1: torch.Tensor, k2: torch.Tensor,
                          k3: torch.Tensor) -> torch.Tensor:
    """Kernel G's plain version: three f32 convs with the kernel's roundings
    (the CUDA caller must disable TF32 for cuDNN to keep them f32). The
    weights are (O, K + 1) matrices or ``PackedConv``."""
    w1, k2, k3 = _aug(w1), _aug(k2), _aug(k3)
    xf = x.to(_BF16).float().permute(0, 3, 1, 2)
    z = _conv(xf, w1, 1, 1).to(_BF16).float()
    y = (_conv(z, k2, 3, 1) + xf).to(_BF16).float()
    out = _conv(y, k3, 3, 2).to(_BF16)
    return out.permute(0, 2, 3, 1).contiguous()


class PackedConv(NamedTuple):
    """One conv of the block as kernel G reads it. ``image``: bf16, the
    kernel's shared-memory image of the [K][O] matrix, per block of a
    cluster of two (w1 whole; k2 split by output channel, 32 of 64 each; k3
    by input channel, the K rows of y's channels [32 r, 32 r + 32) for all
    128 outputs), each 32-channel slice in 64-byte-swizzled 8-row atoms.
    ``bias``: f32 of the bf16-rounded bias, split by the output channels
    each block finishes. ``aug``: the (O, K + 1) matrix it was made from,
    the plain version's operand."""
    image: torch.Tensor
    bias: torch.Tensor
    aug: torch.Tensor


# (name, (O, K + 1), how the two blocks of a cluster split it)
_CONVS = (("w1", (32, 65), None), ("k2", (64, 289), "out"),
          ("k3", (128, 577), "in"))


def sw64_image(kn: torch.Tensor) -> torch.Tensor:
    """(K, 32) [k][n] -> (K * 32,): 8-row atoms of 512 bytes, k ascending,
    16-byte group g of row r at position g ^ ((r / 2) % 4): the layout of a
    64-byte-swizzled N-major wgmma operand (``csrc/wgmma.cuh``)."""
    k, n = kn.shape
    r = torch.arange(k, device=kn.device)[:, None]
    col = torch.arange(n, device=kn.device)[None, :]
    pos = ((r // 8) * 256 + (r % 8) * 32
           + ((col // 8) ^ ((r % 8) // 2)) * 8 + col % 8)
    image = torch.empty(k * n, dtype=kn.dtype, device=kn.device)
    image[pos.flatten()] = kn.flatten()
    return image


def _slices(kn: torch.Tensor) -> torch.Tensor:
    """(K, O) -> the O / 32 swizzled images of its 32-column slices, end to
    end."""
    return torch.cat([sw64_image(kn[:, c:c + 32])
                      for c in range(0, kn.shape[1], 32)])


def pack_conv(k_aug: torch.Tensor, split=None) -> PackedConv:
    """(O, K + 1) -> ``PackedConv``: the whole matrix in one image (split
    None), or one image per block of the cluster, split by output channel
    ("out") or by the input channel of each tap ("in": a 3x3 conv over 64
    channels, block r taking channels [32 r, 32 r + 32))."""
    kq = k_aug.to(_BF16)
    kn = kq[:, :-1].t()                      # (K, O), K = tap * C + channel
    bias = kq[:, -1].float()
    if split is None:
        return PackedConv(_slices(kn), bias.contiguous(), k_aug)
    o = kn.shape[1]
    if split == "out":
        parts = [kn[:, r * o // 2:(r + 1) * o // 2] for r in range(2)]
    else:
        taps = kn.reshape(9, -1, o)
        c = taps.shape[1] // 2
        parts = [taps[:, r * c:(r + 1) * c].reshape(-1, o) for r in range(2)]
    return PackedConv(torch.stack([_slices(p) for p in parts]),
                      bias.reshape(2, o // 2).contiguous(), k_aug)


def pack_block_weights(w1, k2, k3):
    """(w1, k2, k3) as ``fold_block_weights`` gives them -> three
    ``PackedConv``: what ``post_stem_block`` takes already packed."""
    return tuple(pack_conv(k, split)
                 for k, (_, _, split) in zip((w1, k2, k3), _CONVS))


def _aug(k):
    return k.aug if isinstance(k, PackedConv) else k


def _post_stem_block_cuda(x, w1, k2, k3, stage: int) -> torch.Tensor:
    b, h, w, c = x.shape
    dev = x.device
    if c != 64 or x.dtype != _BF16:
        raise ValueError(f"x: expected (B, H, W, 64) bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    packed = []
    for (name, shape, split), t in zip(_CONVS, (w1, k2, k3)):
        aug = _aug(t)
        if (tuple(aug.shape) != shape or aug.device != dev
                or aug.dtype not in (torch.float32, _BF16)):
            raise ValueError(f"{name}: expected {shape} float32 or bfloat16 "
                             f"on {dev}, got {tuple(aug.shape)} {aug.dtype} "
                             f"on {aug.device}")
        p = t if isinstance(t, PackedConv) else pack_conv(t, split)
        o, k = shape[0], shape[1] - 1
        want = ((o * k,), (o,)) if split is None else ((2, o * k // 2),
                                                       (2, o // 2))
        if ((tuple(p.image.shape), tuple(p.bias.shape)) != want
                or p.image.dtype != _BF16 or p.bias.dtype != torch.float32
                or not (p.image.is_contiguous() and p.bias.is_contiguous())
                or p.image.device != dev or p.bias.device != dev):
            raise ValueError(f"{name}: packed operands must be {want[0]} "
                             f"bfloat16 and {want[1]} float32, contiguous, "
                             f"on {dev}")
        packed.append(p)
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned (the kernel copies "
                         "pixels as 16-byte vectors)")
    out = torch.empty((b, (h + 1) // 2, (w + 1) // 2, 128), dtype=_BF16,
                      device=dev)
    (i1, c1, _), (i2, c2, _), (i3, c3, _) = packed
    kernels.POST_STEM_BLOCK(
        x.data_ptr(), i1.data_ptr(), i2.data_ptr(), i3.data_ptr(),
        c1.data_ptr(), c2.data_ptr(), c3.data_ptr(), out.data_ptr(), b, h, w,
        stage, kernels.stream_of(x))
    return out


@torch.no_grad()   # inference only: the kernel has no backward
def post_stem_block_stage(x: torch.Tensor, w1: torch.Tensor, k2: torch.Tensor,
                          k3: torch.Tensor, stage: str) -> torch.Tensor:
    """Kernel G cut off after ``stage`` of ``BLOCK_STAGES``, same operands
    and output shape as ``post_stem_block``. Only "full" computes the block;
    a cut-off stage stores a tile of what it produced last and exists to be
    timed, so it has no plain version: on the CPU it raises."""
    index = BLOCK_STAGES.index(stage)
    if x.is_cuda:
        return _post_stem_block_cuda(x, w1, k2, k3, index)
    if x.device.type == "cpu":
        if stage != "full":
            raise ValueError(f"stage {stage!r} of the block kernel exists "
                             "only as a CUDA kernel; on the CPU only 'full' "
                             "is defined")
        return post_stem_block_plain(x, w1, k2, k3)
    raise ValueError(f"no block kernel for device {x.device}")


def post_stem_block(x: torch.Tensor, w1: torch.Tensor, k2: torch.Tensor,
                    k3: torch.Tensor) -> torch.Tensor:
    """Kernel G: x (B, H, W, 64) bf16, w1 (32, 65), k2 (64, 289), k3
    (128, 577), each also as its ``PackedConv`` -> (B, ceil(H/2),
    ceil(W/2), 128) bf16 NHWC."""
    return post_stem_block_stage(x, w1, k2, k3, "full")
