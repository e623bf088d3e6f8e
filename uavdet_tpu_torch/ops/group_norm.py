"""GroupNorm with one group, in inference, with its kernel.

RTMUAVDet's ``MDyEncoder`` normalises whole maps with ``nn.GroupNorm(1,
C)``: each sample of x (B, C, *) by the mean and the biased variance of all
its values, then the per-channel affine,

    y[b, c] = (x[b, c] - mean[b]) * (rstd[b] * weight[c]) + bias[c],
    rstd[b] = rsqrt(var[b] + eps).

Moments, normalisation and affine are f32 and the result is rounded to x's
dtype once, as PyTorch's GroupNorm does for bf16. The JAX package leaves
GroupNorm to XLA; the kernel (``csrc/group_norm1.cu``) exists because
PyTorch's CUDA GroupNorm reduces a sample in one block, which leaves most of
the card idle at a served batch of 8. It cuts each sample into
``gn1_chunks`` chunks, one block each, and takes two launches (moments, then
the apply), counted as one.

``group_norm1`` dispatches on the device of ``x``: a CPU tensor takes the
plain PyTorch version ``group_norm1_plain``, a CUDA tensor launches the
kernel, anything else raises. It calls the registered operator
``torch.ops.uavdet.group_norm1(x, weight, bias, eps) -> y``, whose
implementation makes that choice and whose fake implementation gives the
output's shape (inference only: no autograd).
"""

import functools

import torch
import torch.nn.functional as F
from torch import nn

from .. import kernels, tracing

_BF16 = torch.bfloat16

BLOCKS_PER_SM = 4     # the blocks of a launch, per SM of the card
MIN_CHUNK = 4096      # values of a sample a block takes at least

# (B, C, H, W, shift) at the edges of the kernel's chunking: chunks of a
# multiple of 8 values, 16-byte vectors of 8 bf16 or 4 f32 values inside one
# channel where H * W % 8 == 0, a scalar path otherwise. ``shift`` is the
# values' mean in units of their standard deviation. The CPU tests hold the
# plain version against a float64 ``F.group_norm`` at these shapes, the card
# tests the kernel against the plain version.
GN1_EDGE_SHAPES = (
    (2, 5, 7, 9, 0.0),        # H W = 63, not a multiple of 8: the scalar path
    (3, 8, 4, 4, 0.0),        # 128 values a sample, under one chunk
    (1, 24, 40, 40, 0.0),     # B = 1: nine chunks, the last one part full
    (4, 1, 64, 96, 0.0),      # C = 1
    (2, 16, 32, 32, 1e3),     # mean 1e3 std: E[x^2] - E[x]^2 would cancel
    (3, 6, 5, 8, 0.0),        # H W = 40: vectors, a chunk of 240 values
)


def gn1_chunks(b: int, n: int, sms: int) -> int:
    """The chunks S that each of ``b`` samples of ``n`` values is cut into
    on a card of ``sms`` SMs: enough blocks to fill every SM
    ``BLOCKS_PER_SM`` times, each chunk ``MIN_CHUNK`` values at least (one
    chunk for a smaller sample)."""
    return max(1, min(-(-BLOCKS_PER_SM * sms // b), n // MIN_CHUNK))


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(x, weight, bias):
    if x.dim() < 2:
        raise ValueError(f"x must be (B, C, *), got {tuple(x.shape)}")
    if x.dtype not in (_BF16, torch.float32):
        raise ValueError(f"group_norm1 takes bf16 or float32, got {x.dtype}")
    b, c = x.shape[:2]
    if tuple(weight.shape) != (c,) or tuple(bias.shape) != (c,):
        raise ValueError(f"weight and bias must be {(c,)}, got "
                         f"{tuple(weight.shape)} and {tuple(bias.shape)}")
    return b, c, x[0, 0].numel()


def group_norm1_plain(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, eps: float) -> torch.Tensor:
    """The kernel's plain version: PyTorch's GroupNorm of one group on the
    f32 values (f32 moments with the biased variance, f32 affine), one
    rounding to ``x.dtype``; in float32 it is ``nn.GroupNorm`` itself."""
    _check(x, weight, bias)
    return F.group_norm(x.float(), 1, weight.float(), bias.float(),
                        eps).to(x.dtype)


def _group_norm1_cuda(x, weight, bias, eps):
    b, c, hw = _check(x, weight, bias)
    for name, t in (("weight", weight), ("bias", bias)):
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, x "
                             f"{x.dtype} on {x.device}")
    if not (x.is_contiguous() and weight.is_contiguous()
            and bias.is_contiguous()):
        raise ValueError("the group_norm1 kernel takes contiguous x, weight "
                         f"and bias, got x's strides {x.stride()}")
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    s = gn1_chunks(b, c * hw, _sms(x.device.index))
    workspace = torch.empty((b, s, 3), dtype=torch.float32, device=x.device)
    kernels.GROUP_NORM1(x.data_ptr(), int(x.dtype == _BF16), weight.data_ptr(),
                        bias.data_ptr(), y.data_ptr(), workspace.data_ptr(), b,
                        c, hw, s, float(eps), kernels.stream_of(x))
    return y


@torch.library.custom_op("uavdet::group_norm1", mutates_args=())
def _group_norm1_op(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, eps: float) -> torch.Tensor:
    kernels.check_device(x, "group_norm1 kernel")
    fn = _group_norm1_cuda if x.is_cuda else group_norm1_plain
    return fn(x, weight, bias, eps)


@_group_norm1_op.register_fake
def _(x, weight, bias, eps):
    kernels.check_device(x, "group_norm1 kernel")
    _check(x, weight, bias)
    return torch.empty_like(x)


def group_norm1(x: torch.Tensor, gn: nn.GroupNorm) -> torch.Tensor:
    """``gn(x)`` for an affine ``nn.GroupNorm`` of one group, in inference,
    through the kernel on a card; there x is made contiguous first, as
    PyTorch's CUDA GroupNorm makes it. Counts ``group_norm1``
    (``tracing.count``, frames = B)."""
    if gn.num_groups != 1 or not gn.affine:
        raise ValueError("group_norm1 takes an affine GroupNorm of one "
                         f"group, got {gn}")
    tracing.count("group_norm1", x.shape[0])
    if x.is_cuda:
        x = x.contiguous()
    return torch.ops.uavdet.group_norm1(x, gn.weight, gn.bias, gn.eps)
