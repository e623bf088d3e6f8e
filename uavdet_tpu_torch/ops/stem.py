"""The two-pass dynamic-conv stem of DyYOLO, with its kernels.

Port of ``uavdet_tpu/ops/pallas_stem_split.py`` (``pallas_l1``,
``pallas_l2``, ``fused_stem_forward``, ``detector_stem_fast_path``) and of
``uavdet_tpu/ops/pallas_stem.py:mix_and_fold``. The first two layers of
DyYOLO, DyConv 3->32 3x3 s1 and DyConv 32->64 3x3 s2 (each + BN + SiLU, in
inference), run as

  glue:     attention 1 from the frame's channel means, K1 = mix_and_fold
  kernel A: a1 = SiLU(conv(x, K1)) in bf16 + the channel sums of a1
  glue:     attention 2 from those sums, K2 = mix_and_fold
  kernel B: out = SiLU(conv_s2(a1, K2)) in bf16

The split is forced by the second attention: it pools the whole first
activation, so K2 cannot exist before kernel A has run over all of it.

``stem_fused`` (port of ``pallas_stem.py:pallas_dyconv_stem``, kernel E,
``csrc/stem_fused.cu``) runs both layers in one kernel for a caller that
already holds K1 and K2; the first activation then never reaches device
memory. No detector can call it, for the reason above: it is a public op.
``stem_l2_stage`` launches kernel B cut off after one stage of its ladder
(port of the TPU harness ``scripts/l2_ablate.py``; see
``uavdet_tpu_torch/scripts/l2_ablate.py``).

Kernel A takes raw uint8 frames: /255 is folded into K1, and the
attention's pooling is taken on the bytes. Both kernels round their
operands to bf16, run their products on the tensor cores with f32 sums,
apply SiLU in f32 and store bf16, as the TPU kernels do. ``stem_l1`` / ``stem_l2`` dispatch on the device of
their input: a CPU tensor takes the plain PyTorch version (``*_plain``), a
CUDA tensor launches the kernel (``csrc/stem_l1.cu``, ``csrc/stem_l2.cu``),
anything else raises.

``stem_l1``, ``stem_l2`` and ``stem_fused`` call the registered operators
``torch.ops.uavdet.stem_l1`` / ``stem_l2`` / ``stem_fused``, whose
implementations make that choice; their fake implementations give only the
outputs' shapes and dtypes, so that ``torch.export`` traces through them.
Inference only: no autograd formula is registered, and a backward through
one raises. ``stem_l2_stage`` is a measuring aid and stays a plain function.
"""

from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import kernels
from ..parallel.spatial import sp_sum

_BF16 = torch.bfloat16


def mix_and_fold(weights: torch.Tensor, attn: torch.Tensor,
                 bn: torch.nn.BatchNorm2d) -> torch.Tensor:
    """Per-sample expert mixing + inference BN folded into one matrix.

    weights: (E, O, I, k, k) experts; attn: (B, E) softmax weights.
    -> (B, O, k*k*I + 1) f32: taps ordered ki-major, then kj, then channel,
    and the folded bias as the last column.
    """
    e, o, i, kh, kw = weights.shape
    taps = weights.float().permute(0, 1, 3, 4, 2).reshape(e, o, kh * kw * i)
    mixed = torch.einsum("eop,be->bop", taps, attn.float())
    inv = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
    bias = bn.bias.float() - bn.running_mean.float() * inv
    return torch.cat([mixed * inv[None, :, None],
                      bias[None, :, None].expand(attn.shape[0], o, 1)], dim=-1)


def stem_l1_weights(x: torch.Tensor, dyconv, attn_temp: float,
                    sp_group=None) -> torch.Tensor:
    """K1 (B, 32, 28) f32 for frames x (B, H, W, 3), uint8 or float in [0, 1].

    For uint8 the attention pools the bytes (an exact integer sum) and the
    1/255 of the normalization is folded into the 27 tap columns; the bias
    column is not scaled. With ``sp_group`` x is a band of the frames' rows
    and the pool is summed over the group (the bytes' sum stays an exact
    integer sum).
    """
    b, h, w, _ = x.shape
    n = 1 if sp_group is None else dist.get_world_size(sp_group)
    if x.dtype == torch.uint8:
        pooled = sp_sum(x.sum(dim=(1, 2)), sp_group).float() / float(
            n * h * w * 255.0)
    elif sp_group is None:
        pooled = x.float().mean(dim=(1, 2))
    else:
        pooled = sp_sum(x.float().sum(dim=(1, 2)), sp_group) / float(
            n * h * w)
    k1 = mix_and_fold(dyconv.weights, dyconv.attention_weights(
        pooled, attn_temp), dyconv.bn)
    if x.dtype == torch.uint8:
        k1 = torch.cat([k1[..., :-1] / 255.0, k1[..., -1:]], dim=-1)
    return k1


def stem_l2_weights(sums: torch.Tensor, hw: int, dyconv,
                    attn_temp: float) -> torch.Tensor:
    """K2 (B, 64, 289) f32 from kernel A's channel sums over ``hw`` pixels."""
    return mix_and_fold(dyconv.weights, dyconv.attention_weights(
        sums / float(hw), attn_temp), dyconv.bn)


def _per_sample_conv(x_nhwc: torch.Tensor, k_aug: torch.Tensor,
                     stride: int) -> torch.Tensor:
    """SiLU(conv3x3 p1(x[b], K[b]) + bias[b]) in f32 -> NHWC bf16.

    Operands are the bf16 values the kernels see; the grouped conv runs in
    f32 (the CUDA caller must disable TF32 for cuDNN to keep it f32).
    """
    b, h, w, c = x_nhwc.shape
    o = k_aug.shape[1]
    k = k_aug.to(_BF16).float()
    weight = k[..., :-1].reshape(b, o, 3, 3, c).permute(0, 1, 4, 2, 3)
    y = F.conv2d(x_nhwc.float().permute(0, 3, 1, 2).reshape(1, b * c, h, w),
                 weight.reshape(b * o, c, 3, 3), k[..., -1].reshape(b * o),
                 stride=stride, padding=1, groups=b)
    y = F.silu(y).reshape(b, o, y.shape[-2], y.shape[-1])
    return y.to(_BF16).permute(0, 2, 3, 1).contiguous()


def stem_l1_plain(x: torch.Tensor, k1: torch.Tensor):
    """Kernel A's plain version: x (B, H, W, 3) uint8 or float, K1
    (B, 32, 28) -> (a1 (B, H, W, 32) bf16, sums (B, 32) f32)."""
    xq = x if x.dtype == torch.uint8 else x.to(_BF16)
    a1 = _per_sample_conv(xq, k1, stride=1)
    return a1, a1.float().sum(dim=(1, 2))


def stem_l2_plain(a1: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    """Kernel B's plain version: a1 (B, H, W, 32) bf16, K2 (B, 64, 289)
    -> (B, ceil(H/2), ceil(W/2), 64) bf16."""
    return _per_sample_conv(a1, k2, stride=2)


def stem_fused_plain(x: torch.Tensor, k1: torch.Tensor,
                     k2: torch.Tensor) -> torch.Tensor:
    """Kernel E's plain version: kernel B's of kernel A's. The first
    activation is rounded to bf16 in between, and the second conv pads it
    with zeros (not with SiLU(bias))."""
    return stem_l2_plain(stem_l1_plain(x, k1)[0], k2)


def _check_cuda(name, t, shape, dtypes, device):
    if tuple(t.shape) != shape or t.dtype not in dtypes or t.device != device:
        raise ValueError(f"{name}: expected {shape} {dtypes} on {device}, "
                         f"got {tuple(t.shape)} {t.dtype} on {t.device}")


def _stem_l1_cuda(x: torch.Tensor, k1: torch.Tensor):
    b, h, w, _ = x.shape
    _check_cuda("x", x, (b, h, w, 3), (torch.uint8, torch.float32, _BF16,
                                       torch.float16), x.device)
    _check_cuda("k1", k1, (b, 32, 28), (torch.float32, _BF16), x.device)
    xq = (x if x.dtype == torch.uint8 else x.to(_BF16)).contiguous()
    kq = k1.to(_BF16).contiguous()
    n_part = kernels.library().uavdet_stem_l1_num_partials(h, w)
    a1 = torch.empty((b, h, w, 32), dtype=_BF16, device=x.device)
    partial = torch.empty((b, n_part, 32), dtype=torch.float32,
                          device=x.device)
    kernels.STEM_L1(xq.data_ptr(), int(xq.dtype == torch.uint8),
                    kq.data_ptr(), a1.data_ptr(), partial.data_ptr(),
                    b, h, w, kernels.stream_of(xq))
    return a1, partial.sum(dim=1)


# Shapes (B, H, W) of the frames at the edges of kernel A's tiling: a block
# takes 16 rows x 64 columns, a warp 16 columns of it as one m16 fragment, a
# lane the fragment's pixels g and g + 8. The CPU tests hold the plain version
# against a float64 conv at these shapes (uint8 and float frames), the smoke
# test the kernel against the plain version on the card.
L1_EDGE_SHAPES = (
    (1, 1, 1),        # one pixel: every tap but the centre is padding
    (2, 9, 13),       # odd both ways, under one tile
    (1, 17, 65),      # one row and one column past a tile
    (1, 15, 63),      # a row and a column short of a tile
    (2, 32, 72),      # two tiles of rows; half a fragment past a tile
    (1, 64, 128),     # whole tiles, a shape the TPU kernel takes too
)

# Shapes (B, H, W) of a1 at the edges of kernel B's tiling: a tile is 16 x 16
# output pixels, 33 x 33 of a1; with an odd H or W the last output row or
# column reads the image's last pixel as its centre tap. The CPU tests hold
# the plain version against a float64 conv at these shapes, the smoke test
# the kernel against the plain version on the card.
L2_EDGE_SHAPES = (
    (1, 1, 1),        # one pixel: every tap but the centre is padding
    (2, 9, 13),       # odd both ways, under one tile
    (1, 33, 35),      # one output row and two columns past a tile
    (1, 31, 65),      # a row short of a tile; one column past two tiles
    (2, 64, 30),      # two tiles of rows, a column short of one
    (1, 48, 128),     # 1.5 x 4 tiles, a shape the TPU kernel takes too
)

# Kernel B's stage ladder: each stage adds one step to the one before it.
L2_STAGES = ("store", "+k2", "+window", "+mma", "full")


def _stem_l2_cuda(a1: torch.Tensor, k2: torch.Tensor,
                  stage: int | None = None) -> torch.Tensor:
    """Kernel B, or with ``stage`` the ladder's kernel cut off after it."""
    b, h, w, _ = a1.shape
    _check_cuda("a1", a1, (b, h, w, 32), (_BF16,), a1.device)
    _check_cuda("k2", k2, (b, 64, 289), (torch.float32, _BF16), a1.device)
    a1 = a1.contiguous()
    if a1.data_ptr() % 16:
        raise ValueError("a1 must be 16-byte aligned (kernel B reads pixels "
                         "as 16-byte vectors)")
    kq = k2.to(_BF16).contiguous()
    out = torch.empty((b, (h + 1) // 2, (w + 1) // 2, 64), dtype=_BF16,
                      device=a1.device)
    if stage is None:
        kernels.STEM_L2(a1.data_ptr(), kq.data_ptr(), out.data_ptr(), b, h,
                        w, kernels.stream_of(a1))
    else:
        kernels.STEM_L2_STAGE(a1.data_ptr(), kq.data_ptr(), out.data_ptr(),
                              b, h, w, stage, kernels.stream_of(a1))
    return out


def _stem_fused_cuda(x: torch.Tensor, k1: torch.Tensor,
                     k2: torch.Tensor) -> torch.Tensor:
    b, h, w, _ = x.shape
    _check_cuda("x", x, (b, h, w, 3), (torch.uint8, torch.float32, _BF16,
                                       torch.float16), x.device)
    _check_cuda("k1", k1, (b, 32, 28), (torch.float32, _BF16), x.device)
    _check_cuda("k2", k2, (b, 64, 289), (torch.float32, _BF16), x.device)
    xq = (x if x.dtype == torch.uint8 else x.to(_BF16)).contiguous()
    k1q = k1.to(_BF16).contiguous()
    k2q = k2.to(_BF16).contiguous()
    out = torch.empty((b, (h + 1) // 2, (w + 1) // 2, 64), dtype=_BF16,
                      device=x.device)
    kernels.STEM_FUSED(xq.data_ptr(), int(xq.dtype == torch.uint8),
                       k1q.data_ptr(), k2q.data_ptr(), out.data_ptr(), b, h,
                       w, kernels.stream_of(xq))
    return out


@torch.library.custom_op("uavdet::stem_l1", mutates_args=())
def _stem_l1_op(x: torch.Tensor,
                k1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    kernels.check_device(x, "stem kernel")
    return _stem_l1_cuda(x, k1) if x.is_cuda else stem_l1_plain(x, k1)


@_stem_l1_op.register_fake
def _(x, k1):
    kernels.check_device(x, "stem kernel")
    b, h, w, _ = x.shape
    return (x.new_empty((b, h, w, 32), dtype=_BF16),
            x.new_empty((b, 32), dtype=torch.float32))


def _l2_out(a1: torch.Tensor) -> torch.Tensor:
    b, h, w, _ = a1.shape
    return a1.new_empty((b, (h + 1) // 2, (w + 1) // 2, 64), dtype=_BF16)


@torch.library.custom_op("uavdet::stem_l2", mutates_args=())
def _stem_l2_op(a1: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    kernels.check_device(a1, "stem kernel")
    return _stem_l2_cuda(a1, k2) if a1.is_cuda else stem_l2_plain(a1, k2)


@_stem_l2_op.register_fake
def _(a1, k2):
    kernels.check_device(a1, "stem kernel")
    return _l2_out(a1)


@torch.library.custom_op("uavdet::stem_fused", mutates_args=())
def _stem_fused_op(x: torch.Tensor, k1: torch.Tensor,
                   k2: torch.Tensor) -> torch.Tensor:
    kernels.check_device(x, "stem kernel")
    return (_stem_fused_cuda(x, k1, k2) if x.is_cuda
            else stem_fused_plain(x, k1, k2))


@_stem_fused_op.register_fake
def _(x, k1, k2):
    kernels.check_device(x, "stem kernel")
    return _l2_out(x)


def stem_l1(x: torch.Tensor, k1: torch.Tensor):
    """Kernel A: (a1 (B, H, W, 32) bf16, channel sums of a1 (B, 32) f32)."""
    return torch.ops.uavdet.stem_l1(x, k1)


def stem_l2(a1: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    """Kernel B: (B, ceil(H/2), ceil(W/2), 64) bf16 NHWC."""
    return torch.ops.uavdet.stem_l2(a1, k2)


def stem_l2_stage(a1: torch.Tensor, k2: torch.Tensor,
                  stage: str) -> torch.Tensor:
    """Kernel B cut off after ``stage`` of ``L2_STAGES``, same operands and
    output shape as ``stem_l2``. Only "full" computes the layer (bitwise
    kernel B's output); a cut-off stage stores a cheap function of its last
    step and exists to be timed, so it has no plain version: on the CPU it
    raises."""
    index = L2_STAGES.index(stage)
    if a1.is_cuda:
        return _stem_l2_cuda(a1, k2, stage=index)
    if a1.device.type == "cpu":
        if stage != "full":
            raise ValueError(f"stage {stage!r} of kernel B exists only as a "
                             "CUDA kernel; on the CPU only 'full' is defined")
        return stem_l2_plain(a1, k2)
    raise ValueError(f"no stem kernel for device {a1.device}")


def stem_fused(x: torch.Tensor, k1: torch.Tensor,
               k2: torch.Tensor) -> torch.Tensor:
    """Kernel E: both stem layers in one kernel. x (B, H, W, 3) uint8 (the
    caller has folded /255 into K1, as ``stem_l1_weights`` does) or float
    (rounded to bf16); K1 (B, 32, 28), K2 (B, 64, 289) from ``mix_and_fold``
    -> (B, ceil(H/2), ceil(W/2), 64) bf16 NHWC."""
    return torch.ops.uavdet.stem_fused(x, k1, k2)


@torch.no_grad()   # inference only: the kernels have no backward
def fused_stem_forward(x: torch.Tensor, dy0, dy1, attn_temp: float,
                       l1=stem_l1, l2=stem_l2) -> torch.Tensor:
    """The first two DyConv layers (+ BN + SiLU) of DyYOLO in inference.

    x: (B, H, W, 3) raw uint8 frames or preprocessed float frames in [0, 1];
    dy0, dy1: the model's two stem ``DyConvModule``s. -> (B, ceil(H/2),
    ceil(W/2), 64) bf16 NHWC. ``l1`` and ``l2`` are the two kernels; a
    caller that holds the kernels against their plain versions passes
    ``stem_l1_plain`` and ``stem_l2_plain``.
    """
    _, h, w, _ = x.shape
    a1, sums = l1(x, stem_l1_weights(x, dy0, attn_temp))
    return l2(a1, stem_l2_weights(sums, h * w, dy1, attn_temp))


# halo rows of the frames that the stem takes on a band of rows: two above
# (kernel B's band of a1 must start on an even row, one row before the
# band's first; kernel A needs one more above it) and one below
STEM_HALO = (2, 1)


@torch.no_grad()   # inference only: the kernels have no backward
def fused_stem_rows(x: torch.Tensor, top: int, bottom: int, dy0, dy1,
                    attn_temp: float, sp_group, l1=stem_l1,
                    l2=stem_l2) -> torch.Tensor:
    """``fused_stem_forward`` on a band of the frames' rows (``sp``).

    x: (B, top + h + bottom, W, 3), the band of h rows with ``top`` rows
    above it and ``bottom`` below: ``STEM_HALO``, or 0 where the band is at
    the image's edge. -> the band's rows of the stem's output, (B, h/2,
    ceil(W/2), 64) bf16 NHWC (h even). Kernel A runs on all of x: its first
    and last rows see its own zero padding and are not used, save that
    kernel B reads the first (at top 2) only for an output row that is
    dropped. The attention pools are the whole image's: the frame pool and
    kernel A's channel sums (the halo rows' sums taken out) are summed over
    ``sp_group``.
    """
    _, hh, w, _ = x.shape
    h = hh - top - bottom
    n = dist.get_world_size(sp_group)
    a1, sums = l1(x, stem_l1_weights(x[:, top:top + h], dy0, attn_temp,
                                     sp_group))
    halo = torch.cat([a1[:, :top], a1[:, top + h:]], dim=1)
    own = sums - halo.float().sum(dim=(1, 2))
    k2 = stem_l2_weights(sp_sum(own, sp_group), n * h * w, dy1, attn_temp)
    return l2(a1[:, :top + h], k2)[:, top // 2:]


class StemFastPath(NamedTuple):
    """The pieces the detector composes: ``tail(stem(frames))`` are the
    model's per-head outputs; ``rows(x, top, bottom, group)`` is ``stem``
    on a band of rows (``fused_stem_rows``)."""

    stem: object   # (B, H, W, 3) frames -> (B, H/2, W/2, 64) bf16 NHWC
    tail: object   # that activation -> list of DetectionResults
    rows: object = None


STEM_TOKENS = (("DyConv", 32, 3, 1), ("DyConv", 64, 3, 2))


def detector_stem_fast_path(model) -> StemFastPath | None:
    """The stem kernels + the rest of ``model``, or None when the model has
    no ``layer_config`` or it does not start with the DyConv(32,3,1),
    DyConv(64,3,2) stem these kernels implement."""
    if tuple(getattr(model, "tokens", ())[:2]) != STEM_TOKENS:
        return None
    dy0, dy1 = model.layers[0], model.layers[1]
    temp = model.attn_temperature

    def stem(x):
        return fused_stem_forward(x, dy0, dy1, temp)

    def tail(a):
        return model(a, start=len(STEM_TOKENS))

    def rows(x, top, bottom, group):
        return fused_stem_rows(x, top, bottom, dy0, dy1, temp, group)

    return StemFastPath(stem, tail, rows)
