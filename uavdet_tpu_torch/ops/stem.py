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

Kernel A takes raw uint8 frames: /255 is folded into K1, and the
attention's pooling is taken on the bytes. Both kernels round their
operands to bf16, accumulate in f32, apply SiLU in f32 and store bf16, as
the TPU kernels do. ``stem_l1`` / ``stem_l2`` dispatch on the device of
their input: a CPU tensor takes the plain PyTorch version (``*_plain``), a
CUDA tensor launches the kernel (``csrc/stem_l1.cu``, ``csrc/stem_l2.cu``),
anything else raises.
"""

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import kernels

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


def stem_l1_weights(x: torch.Tensor, dyconv, attn_temp: float) -> torch.Tensor:
    """K1 (B, 32, 28) f32 for frames x (B, H, W, 3), uint8 or float in [0, 1].

    For uint8 the attention pools the bytes (an exact integer sum) and the
    1/255 of the normalization is folded into the 27 tap columns; the bias
    column is not scaled.
    """
    b, h, w, _ = x.shape
    if x.dtype == torch.uint8:
        pooled = x.sum(dim=(1, 2)).float() / float(h * w * 255.0)
    else:
        pooled = x.float().mean(dim=(1, 2))
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


def _stem_l2_cuda(a1: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
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
    kernels.STEM_L2(a1.data_ptr(), kq.data_ptr(), out.data_ptr(), b, h, w,
                    kernels.stream_of(a1))
    return out


def stem_l1(x: torch.Tensor, k1: torch.Tensor):
    """Kernel A: (a1 (B, H, W, 32) bf16, channel sums of a1 (B, 32) f32)."""
    if x.is_cuda:
        return _stem_l1_cuda(x, k1)
    if x.device.type == "cpu":
        return stem_l1_plain(x, k1)
    raise ValueError(f"no stem kernel for device {x.device}")


def stem_l2(a1: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    """Kernel B: (B, ceil(H/2), ceil(W/2), 64) bf16 NHWC."""
    if a1.is_cuda:
        return _stem_l2_cuda(a1, k2)
    if a1.device.type == "cpu":
        return stem_l2_plain(a1, k2)
    raise ValueError(f"no stem kernel for device {a1.device}")


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


class StemFastPath(NamedTuple):
    """The pieces the detector composes: ``tail(stem(frames))`` are the
    model's per-head outputs."""

    stem: object   # (B, H, W, 3) frames -> (B, H/2, W/2, 64) bf16 NHWC
    tail: object   # that activation -> list of DetectionResults


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

    return StemFastPath(stem, tail)
