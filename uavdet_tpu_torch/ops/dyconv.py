"""The per-sample dynamic 3x3 conv of DySOEM's ``DynamicSOEM``, with its
kernel.

Port of ``uavdet_tpu/ops/pallas_dyconv.py`` (``mixed_kernel``, ``mixed_bias``,
``pallas_dyconv``). Conv is linear in its kernel, so attention over E expert
convs equals one conv with the per-sample attention-mixed kernel:

  glue:     attn (B, E) -> k = mixed_kernel(experts, attn) (B, 9, C, Co),
            mul (Co,) and add (B, Co): inference BN and the mixed expert
            bias folded into one affine
  kernel D: out[b] = SiLU(conv3x3 SAME s1(x[b], k[b]) * mul + add[b])

Operands are bf16, sums f32, the affine and SiLU f32, one rounding to bf16
at the store, as on the TPU. Taps are ``3*dy + dx``; zero padding applies to
x only. Two options of the same kernel:

  ``emit_gap``  also returns f32 sums of the *stored* bf16 output by (row
                parity, column parity, channel), (B, 2, 2, Co): the channel
                sums a following space-to-depth consumer pools, so that it
                need not read the map again;
  ``fold_out``  stores the same values row-folded, (B, H/2, W, 2 Co) with
                ``out[b, i // 2, j, Co * (i % 2) + c]``.

``dyconv`` dispatches on the device of ``x``: a CPU tensor takes the plain
PyTorch version ``dyconv_plain``, a CUDA tensor launches the kernel
(``csrc/dyconv.cu``: a wgmma implicit GEMM on tiles of 256 pixels x 128
channels), anything else raises. It calls the registered operator
``torch.ops.uavdet.dyconv(x, k, mul, add, fold_out, emit_gap) -> (out,
sums)`` (``sums`` empty without ``emit_gap``), whose implementation makes
that choice and whose fake implementation gives the outputs' shapes, so that
``torch.export`` traces through it (inference only: no autograd).
"""

import torch
import torch.nn.functional as F

from .. import kernels

_BF16 = torch.bfloat16

# Shapes (B, H, W, C, Co) at the edges of kernel D's tiling: tiles of 16 x 16
# pixels, K chunks of 16 input channels, N tiles of 64 output channels where
# Co <= 64 and of 128 otherwise. The CPU tests hold the plain version against
# a float64 conv at these shapes, the smoke test the kernel against the plain
# version on the card.
EDGE_SHAPES = (
    (2, 37, 50, 24, 40),     # ragged tiles both ways, 1.5 chunks, part of an N tile of 64
    (1, 5, 19, 72, 136),     # under one tile row, 4.5 chunks, 128 + 8 channels
    (2, 33, 47, 40, 8),      # one row past two tiles, 2.5 chunks, Co = 8
    (1, 16, 32, 16, 64),     # whole tiles, one chunk, a whole N tile of 64
    (1, 18, 16, 8, 72),      # half a chunk; 72 channels take the N tile of 128
    (1, 32, 18, 48, 264),    # two columns past a tile; two N tiles of 128 and 8 more
    (1, 24, 24, 128, 256),   # 1.5 tiles each way, at widths the TPU kernel takes too
)


def mixed_kernel(stacked_kernel: torch.Tensor, attn: torch.Tensor,
                 co: int) -> torch.Tensor:
    """(3, 3, C, E*Co) stacked expert kernel (HWIO, expert-major on the last
    axis) + (B, E) attention -> per-sample tap-major (B, 9, C, Co)."""
    kh, kw, c, eco = stacked_kernel.shape
    k = stacked_kernel.reshape(kh * kw, c, eco // co, co)
    return torch.einsum("tceo,be->btco", k, attn)


def mixed_bias(stacked_bias: torch.Tensor, attn: torch.Tensor,
               co: int) -> torch.Tensor:
    """(E*Co,) stacked bias + (B, E) attention -> (B, Co)."""
    return torch.einsum("eo,be->bo", stacked_bias.reshape(-1, co), attn)


def rfold(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W, 2C): out[:, i, j, C*p + c] =
    x[:, 2i+p, j, c], the ``fold_out`` layout."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w, c).permute(0, 1, 3, 2, 4).reshape(
        b, h // 2, w, 2 * c)


def parity_sums(out: torch.Tensor) -> torch.Tensor:
    """(B, H, W, Co) -> (B, 2, 2, Co) f32: [b, rp, cp, c] is the sum of
    out[b, rp::2, cp::2, c]."""
    o = out.float()
    return torch.stack([torch.stack([o[:, rp::2, cp::2].sum(dim=(1, 2))
                                     for cp in (0, 1)], dim=1)
                        for rp in (0, 1)], dim=1)


def gap_plain_order(sums: torch.Tensor) -> torch.Tensor:
    """(B, 2, 2, Co) [rp, cp, c] -> (B, 2, 2 Co) [rp, cp*Co + c]: the order
    of the TPU kernel's plain mode, and of space_to_depth's channels."""
    b, _, _, co = sums.shape
    return sums.reshape(b, 2, 2 * co)


def gap_fold_order(sums: torch.Tensor) -> torch.Tensor:
    """(B, 2, 2, Co) [rp, cp, c] -> (B, 2, 2 Co) [cp, rp*Co + c]: the order
    of the TPU kernel's fold mode (column parity, folded channel)."""
    b, _, _, co = sums.shape
    return sums.permute(0, 2, 1, 3).reshape(b, 2, 2 * co)


def _check(x, k, mul, add, fold_out):
    b, h, w, c = x.shape
    co = k.shape[-1]
    if tuple(k.shape) != (b, 9, c, co):
        raise ValueError(f"k must be {(b, 9, c, co)}, got {tuple(k.shape)}")
    if tuple(mul.shape) != (co,) or tuple(add.shape) != (b, co):
        raise ValueError(f"mul must be {(co,)} and add {(b, co)}, got "
                         f"{tuple(mul.shape)} and {tuple(add.shape)}")
    if fold_out and h % 2:
        raise ValueError(f"fold_out needs an even H, got {h}")
    return b, h, w, c, co


def dyconv_plain(x: torch.Tensor, k: torch.Tensor, mul: torch.Tensor,
                 add: torch.Tensor, fold_out: bool = False,
                 emit_gap: bool = False):
    """Kernel D's plain version. x (B, H, W, C), k (B, 9, C, Co), mul (Co,),
    add (B, Co) -> (B, H, W, Co) bf16 NHWC (row-folded with ``fold_out``),
    and with ``emit_gap`` also the (B, 2, 2, Co) f32 sums.

    Operands are rounded to bf16; the grouped conv (groups = batch) runs in
    f32 (a CUDA caller must disable TF32 for cuDNN to keep it f32).
    """
    b, h, w, c, co = _check(x, k, mul, add, fold_out)
    xq = x.to(_BF16).float().permute(0, 3, 1, 2).reshape(1, b * c, h, w)
    # (B, 9, C, Co) -> OIHW (B*Co, C, 3, 3)
    wq = k.to(_BF16).float().permute(0, 3, 2, 1).reshape(b * co, c, 3, 3)
    y = F.conv2d(xq, wq, padding=1, groups=b).reshape(b, co, h, w)
    y = y * mul.float()[None, :, None, None] + add.float()[:, :, None, None]
    out = F.silu(y).to(_BF16).permute(0, 2, 3, 1).contiguous()
    stored = rfold(out) if fold_out else out
    return (stored, parity_sums(out)) if emit_gap else stored


def _dyconv_cuda(x, k, mul, add, fold_out, emit_gap):
    b, h, w, c, co = _check(x, k, mul, add, fold_out)
    for name, t in (("x", x), ("k", k), ("mul", mul), ("add", add)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dtype != _BF16 or not x.is_contiguous():
        raise ValueError("kernel D takes a contiguous bf16 NHWC x, got "
                         f"{x.dtype}, strides {x.stride()}")
    if c % 8 or co % 8:
        raise ValueError("kernel D reads 16-byte vectors: C and Co must be "
                         f"multiples of 8, got {c} and {co}")
    kq = k.to(_BF16).contiguous()
    mq = mul.float().contiguous()
    aq = add.float().contiguous()
    if x.data_ptr() % 16 or kq.data_ptr() % 16:
        raise ValueError("x and k must be 16-byte aligned")
    shape = (b, h // 2, w, 2 * co) if fold_out else (b, h, w, co)
    out = torch.empty(shape, dtype=_BF16, device=x.device)
    if out.numel() == 0:
        return (out, out.new_zeros((b, 2, 2, co), dtype=torch.float32)) \
            if emit_gap else out
    partial = None
    if emit_gap:
        n_part = kernels.library().uavdet_dyconv_num_partials(h, w)
        partial = torch.empty((b, n_part, 2, 2, co), dtype=torch.float32,
                              device=x.device)
    kernels.DYCONV(x.data_ptr(), kq.data_ptr(), mq.data_ptr(), aq.data_ptr(),
                   out.data_ptr(), partial.data_ptr() if emit_gap else None,
                   b, h, w, c, co, int(fold_out), kernels.stream_of(x))
    # per-block partials, written in a fixed order and added here: the sums
    # do not change from run to run (no atomics)
    return (out, partial.sum(dim=1)) if emit_gap else out


@torch.library.custom_op("uavdet::dyconv", mutates_args=())
def _dyconv_op(x: torch.Tensor, k: torch.Tensor, mul: torch.Tensor,
               add: torch.Tensor, fold_out: bool,
               emit_gap: bool) -> tuple[torch.Tensor, torch.Tensor]:
    kernels.check_device(x, "dyconv kernel")
    fn = _dyconv_cuda if x.is_cuda else dyconv_plain
    got = fn(x, k, mul, add, fold_out, emit_gap)
    return got if emit_gap else (got, _no_sums(x))


def _no_sums(x):
    return x.new_empty((0,), dtype=torch.float32)


@_dyconv_op.register_fake
def _(x, k, mul, add, fold_out, emit_gap):
    kernels.check_device(x, "dyconv kernel")
    b, h, w, _, co = _check(x, k, mul, add, fold_out)
    shape = (b, h // 2, w, 2 * co) if fold_out else (b, h, w, co)
    out = x.new_empty(shape, dtype=_BF16)
    if not emit_gap:
        return out, _no_sums(x)
    return out, x.new_empty((b, 2, 2, co), dtype=torch.float32)


def dyconv(x: torch.Tensor, k: torch.Tensor, mul: torch.Tensor,
           add: torch.Tensor, fold_out: bool = False, emit_gap: bool = False):
    """Kernel D: SiLU(conv3x3 SAME(x[b], k[b]) * mul + add[b]) -> bf16 NHWC
    (B, H, W, Co), or (B, H/2, W, 2 Co) with ``fold_out``; with ``emit_gap``
    a pair (out, sums (B, 2, 2, Co) f32 [row parity, column parity, c])."""
    out, sums = torch.ops.uavdet.dyconv(x, k, mul, add, bool(fold_out),
                                        bool(emit_gap))
    return (out, sums) if emit_gap else out
