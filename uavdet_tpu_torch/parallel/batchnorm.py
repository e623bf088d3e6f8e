"""BatchNorm over the global batch: the moments of every rank's rows.

The JAX step applies the model to the globally sharded batch, so its
BatchNorm statistics are over the global batch (``uavdet_tpu/parallel/
mesh.py:229-247``). Under DDP or FSDP2 each process sees its own rows, so
``models.layers.BatchNorm2d`` calls ``global_batch_norm`` in training mode
when ``shard_model`` has given it a process group of more than one rank.

``nn.SyncBatchNorm`` would do the reduction but not the port's rule for the
running variance: flax's biased batch variance, with n the global count of
values per channel. Forward: one all-reduce of (sum x, sum x^2, n) per
channel, summed in float64 (so E[x^2] - E[x]^2 loses nothing a two-pass
float32 variance keeps), then eval-mode ``F.batch_norm`` with those
moments (one fused pass). Backward: the rank's (sum dy, sum dy x_hat) in
one fused pass (``native_batch_norm_backward`` at the global moments), one
all-reduce of them as ``nn.SyncBatchNorm`` does, and dx as an affine map
of dy and x per channel (two ``addcmul`` passes); the affine parameters'
gradients stay the rank's own sums, which the data-parallel wrapper
averages with the rest. A rank with zero rows takes part in both
collectives with zero sums. Nothing waits for the card: the host keeps
queueing the step's work ahead of it.
"""

import torch
import torch.distributed as dist
import torch.nn.functional as F

_DIMS = (0, 2, 3)


def _channel(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


def global_moments(x: torch.Tensor, group) -> tuple:
    """-> (mean, biased variance) per channel over the rows of every rank of
    ``group`` (float64), and the global count of values per channel (a
    tensor of one element). The local count goes in by a fill on the
    device: setting an element from the host would wait for the card."""
    c = x.shape[1]
    s1 = x.sum(_DIMS, dtype=torch.float64)
    s2 = torch.linalg.vector_norm(x, dim=_DIMS, dtype=torch.float64)
    stats = torch.cat([s1, s2 * s2,
                       s1.new_full((1,), x.numel() // max(c, 1))])
    dist.all_reduce(stats, group=group)
    count = stats[2 * c:]
    mean, ex2 = stats[:2 * c].view(2, c) / count
    return mean, ex2.addcmul(mean, mean, value=-1).clamp_min_(0.0), count


class _GlobalBatchNorm(torch.autograd.Function):
    """y = (x - mean) * invstd * weight + bias with the global moments; the
    backward of a BatchNorm over the global batch."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, var, count, eps, group):
        ctx.save_for_backward(x, weight, mean, var, count)
        ctx.eps, ctx.group = eps, group
        # eval-mode BatchNorm with the global moments: one fused pass
        return F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, var, count = ctx.saved_tensors
        invstd = (var + ctx.eps).rsqrt_()
        if x.numel():
            # sum dy * x_hat and sum dy per channel, in one fused pass
            _, d_weight, d_bias = torch.ops.aten.native_batch_norm_backward(
                dy, x, weight, None, None, mean, invstd, True, ctx.eps,
                [False, True, True])
        else:
            d_weight, d_bias = torch.zeros_like(weight), torch.zeros_like(
                weight)
        sums = torch.cat([d_bias, d_weight])
        dist.all_reduce(sums, group=ctx.group)
        g_dy, g_dyx = sums.view(2, -1) / count.to(sums.dtype)
        # dx = w invstd (dy - g_dy - x_hat g_dyx) = a dy - k x - c per
        # channel, from -c - k x in one pass and + a dy in place
        a = weight * invstd
        k = a * invstd * g_dyx
        minus_c = torch.addcmul(k * mean, a, g_dy, value=-1)
        dx = torch.addcmul(_channel(minus_c), x, _channel(k),
                           value=-1).addcmul_(dy, _channel(a))
        return (dx.to(x.dtype), d_weight.to(weight.dtype),
                d_bias.to(weight.dtype), None, None, None, None, None)


def global_batch_norm(x: torch.Tensor, bn) -> torch.Tensor:
    """Training-mode BatchNorm of ``bn`` (affine, tracking running
    statistics) over the global batch of ``bn.process_group``; updates the
    running statistics as flax does: the biased variance, momentum
    ``bn.momentum``."""
    with torch.no_grad():
        mean, var, count = global_moments(x, bn.process_group)
        bn.running_mean.lerp_(mean.to(bn.running_mean.dtype), bn.momentum)
        bn.running_var.lerp_(var.to(bn.running_var.dtype), bn.momentum)
        bn.num_batches_tracked.add_(1)
        # the arithmetic in float32, or in the input's dtype above it
        dtype = torch.promote_types(x.dtype, torch.float32)
        mean, var = mean.to(dtype), var.to(dtype)
    return _GlobalBatchNorm.apply(x, bn.weight, bn.bias, mean, var, count,
                                  bn.eps, bn.process_group)
