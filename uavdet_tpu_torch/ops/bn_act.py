"""The conv blocks' epilogue in inference, with its kernel.

``CNNBlock``, ``ConvModule`` and ``DyConvModule`` (``models/layers.py``)
follow their conv with a BatchNorm, an activation and, in a
``ResidualBlock``, the skip. In inference, on a bf16 map, that is one
pointwise function of the conv's output x:

    y = act((x - mean[c]) * (weight[c] / sqrt(var[c] + eps)) + bias[c])
        [+ residual]

with the BatchNorm's running statistics and affine as they lie in the
module (nothing folded or cached, so a change in place shows at the next
call, a CUDA graph's replay included), ``act`` LeakyReLU(0.1) or SiLU, and
the residual added after the activation. Each step is one f32 operation
and the result is rounded to bf16 once; PyTorch's chain of BatchNorm,
activation and add rounds after each. The kernel (``csrc/bn_act.cu``) does
it in one pass that reads x and the residual once and writes y once.

``bn_act`` dispatches on the device of ``x``: a CPU tensor takes the plain
PyTorch version ``bn_act_plain``, a CUDA tensor launches the kernel,
anything else raises. It calls the registered operator
``torch.ops.uavdet.bn_act(x, mean, var, weight, bias, eps, act, residual)
-> y``, whose implementation makes that choice and whose fake
implementation gives the output's shape (inference only: no autograd). The
kernel takes x channels_last or contiguous NCHW, the residual in x's
layout, and writes y in it; the operator's implementation, which sees the
strides of the call itself, makes them so (``_bn_act_cuda``, which launches
the kernel, raises on any other).
"""

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from .. import kernels, tracing

_BF16 = torch.bfloat16

ACTS = ("leaky_relu", "silu")   # the kernel's ``act`` 0 and 1
NEGATIVE_SLOPE = 0.1            # CNNBlock's LeakyReLU
THREADS = 256                   # csrc/bn_act.cu: a block's threads
UNROLL = 4                      # csrc/bn_act.cu: vectors of x in flight a
                                # thread (two with a residual)
BLOCKS_PER_SM = 4               # the blocks of a launch, per SM of the card:
                                # as many as are resident (csrc/bn_act.cu)
MAX_C = 4096                    # the per-channel table in shared memory

# (B, C, H, W) at the edges of the kernel's three paths, each taken in both
# layouts: channels_last with C % 8 == 0 (a thread's eight channels fixed,
# the launch's threads a multiple of C / 8), NCHW with H W % 8 == 0 (one
# channel a vector), and one value at a time otherwise; batch 1 and 3, odd
# H and W. The CPU tests hold the plain version against a float64 chain at
# these shapes, the card tests the kernel against the plain version.
BN_ACT_EDGE_SHAPES = (
    (1, 8, 5, 7),        # C = 8: one vector a pixel; NCHW one value a time
    (3, 32, 9, 11),      # odd H and W
    (1, 1024, 3, 5),     # C = 1024: 128 vectors a pixel
    (3, 24, 4, 6),       # C / 8 = 3: the grid a multiple of 3; NCHW vectors
    (2, 12, 7, 3),       # C % 8 != 0 and H W % 8 != 0: one value at a time
    (1, 40, 8, 8),       # C / 8 = 5; NCHW vectors
)


def bn_act_grid(numel: int, c: int, channels_last: bool, sms: int) -> int:
    """The blocks of one launch over ``numel`` values of C = ``c`` channels
    on a card of ``sms`` SMs: enough for UNROLL vectors of 8 values a
    thread, at most ``BLOCKS_PER_SM`` a SM; on channels_last maps with C % 8
    == 0, rounded up so that the launch's threads are a multiple of C / 8."""
    need = -(-numel // (8 * THREADS * UNROLL))
    grid = max(1, min(need, BLOCKS_PER_SM * sms))
    if channels_last and c % 8 == 0:
        per = c // 8
        step = per // math.gcd(per, THREADS)
        grid = -(-grid // step) * step
    return grid


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _memory_format(t: torch.Tensor):
    """channels_last or contiguous_format where ``t`` is dense in that
    order (channels_last first), else None."""
    for fmt in (torch.channels_last, torch.contiguous_format):
        if t.is_contiguous(memory_format=fmt):
            return fmt
    return None


def _check(x, mean, var, weight, bias, act, residual):
    if x.dim() != 4 or x.dtype != _BF16:
        raise ValueError(f"bn_act takes a bf16 (B, C, H, W) map, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    c = x.shape[1]
    vectors = (mean, var, weight, bias)
    if any(tuple(t.shape) != (c,) for t in vectors):
        raise ValueError(f"mean, var, weight and bias must be {(c,)}, got "
                         f"{[tuple(t.shape) for t in vectors]}")
    if {t.dtype for t in vectors} not in ({_BF16}, {torch.float32}):
        raise ValueError("mean, var, weight and bias must be all bf16 or all "
                         f"float32, got {[t.dtype for t in vectors]}")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype):
        raise ValueError(f"residual {residual.dtype} {tuple(residual.shape)}"
                         f" differs from x {x.dtype} {tuple(x.shape)}")


def bn_act_plain(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                 weight: torch.Tensor, bias: torch.Tensor, eps: float,
                 act: str, residual: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """The kernel's plain version: each step in f32, in the kernel's order,
    one rounding to bf16; y in x's memory format."""
    _check(x, mean, var, weight, bias, act, residual)
    scale = torch.sqrt(var.float() + eps).reciprocal() * weight.float()
    y = ((x.float() - mean.float()[:, None, None]) * scale[:, None, None]
         + bias.float()[:, None, None])
    y = F.leaky_relu(y, NEGATIVE_SLOPE) if act == "leaky_relu" else F.silu(y)
    if residual is not None:
        y = y + residual.float()
    return y.to(x.dtype)


def _bn_act_cuda(x, mean, var, weight, bias, eps, act, residual):
    _check(x, mean, var, weight, bias, act, residual)
    b, c, h, w = x.shape
    if c > MAX_C:
        raise ValueError(f"the bn_act kernel takes at most {MAX_C} channels, "
                         f"got {c}")
    for name, t in (("mean", mean), ("var", var), ("weight", weight),
                    ("bias", bias), ("residual", residual)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    fmt = _memory_format(x)
    if fmt is None:
        raise ValueError("the bn_act kernel takes x channels_last or "
                         f"contiguous NCHW, got strides {x.stride()}")
    if residual is not None and not residual.is_contiguous(memory_format=fmt):
        raise ValueError(f"the residual's strides {residual.stride()} are "
                         f"not x's layout ({fmt})")
    if not all(t.is_contiguous() for t in (mean, var, weight, bias)):
        raise ValueError("the bn_act kernel takes contiguous BatchNorm "
                         "vectors")
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    cl = fmt == torch.channels_last
    grid = bn_act_grid(x.numel(), c, cl, _sms(x.device.index))
    kernels.BN_ACT(x.data_ptr(),
                   None if residual is None else residual.data_ptr(),
                   y.data_ptr(), mean.data_ptr(), var.data_ptr(),
                   weight.data_ptr(), bias.data_ptr(),
                   int(mean.dtype == _BF16), float(eps), ACTS.index(act), b,
                   c, h * w, int(cl), grid, kernels.stream_of(x))
    return y


@torch.library.custom_op("uavdet::bn_act", mutates_args=())
def _bn_act_op(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
               weight: torch.Tensor, bias: torch.Tensor, eps: float, act: str,
               residual: torch.Tensor | None) -> torch.Tensor:
    kernels.check_device(x, "bn_act kernel")
    if not x.is_cuda:
        return bn_act_plain(x, mean, var, weight, bias, eps, act, residual)
    # the layouts as the call finds them: an exported program's trace may
    # have seen other strides than its run gives
    if _memory_format(x) is None:
        x = x.contiguous()
    if residual is not None:
        residual = residual.contiguous(memory_format=_memory_format(x))
    return _bn_act_cuda(x, mean, var, weight, bias, eps, act, residual)


@_bn_act_op.register_fake
def _(x, mean, var, weight, bias, eps, act, residual):
    kernels.check_device(x, "bn_act kernel")
    _check(x, mean, var, weight, bias, act, residual)
    return torch.empty_like(x)


def bn_act(x: torch.Tensor, bn: nn.BatchNorm2d, act: str,
           residual: torch.Tensor | None = None) -> torch.Tensor:
    """``act(bn(x)) [+ residual]`` for a BatchNorm in inference (its
    running statistics), through the kernel on a card; there the operator
    makes x dense first where it is not, and the residual dense in x's
    layout. Counts ``bn_act`` (``tracing.count``, frames = B)."""
    tracing.count("bn_act", x.shape[0])
    return torch.ops.uavdet.bn_act(x, bn.running_mean, bn.running_var,
                                   bn.weight, bn.bias, bn.eps, act, residual)
