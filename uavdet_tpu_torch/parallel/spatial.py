"""The ``sp`` axis: each rank of an ``sp`` group holds a band of the image's
rows, the port's counterpart of the JAX package's row-sharded activations
(``uavdet_tpu/parallel/mesh.py:19-30``), where GSPMD partitions every
convolution and exchanges the kernel's halo rows between neighbours.

* ``row_band(sp_index, n_sp, height, stride)``: a rank's rows. A deviation,
  stated: GSPMD pads uneven rows; here ``height`` must be a multiple of
  ``n_sp`` times the model's largest stride (``model_stride``), so that
  every stride-2 layer starts its band on an even global row.
* ``halo_exchange(x, top, bottom, group)``: the band with ``top`` rows of
  the rank above and ``bottom`` rows of the rank below attached (zeros at
  the image's own edges). One ``all_gather`` over the group of each rank's
  two edge bands carries the forward; the backward sends the halo rows'
  gradient back to their owners in the same way and adds it there. An
  ``all_gather`` runs on gloo on the CPU, on gloo with CUDA tensors (which
  gloo moves through the host) and on NCCL.
* ``conv2d_rows``: a convolution on a band. A k x k conv of stride s and
  padding p takes ``p`` rows from above and ``k - s - p`` from below and
  convolves without row padding (the columns keep theirs), so that the
  band's first output row is centred on global row ``r0`` (even at stride
  2), as the whole image's conv centres it.
* ``sp_sum``: a sum over the group that autograd differentiates (the
  backward sums the gradient over the group too), for the global-average
  pools and the loss's numerators and denominators.
* ``gather_rows(t, group, dim)``: the inverse of the split, for the heads.

Each module that convolves or pools reads its ``sp_group`` attribute
(None: the whole image). ``set_sp_group`` sets it on every such module of
a model, ``sp_rows`` for the length of a block of code.
"""

import contextlib

import torch
import torch.distributed as dist
import torch.nn.functional as F


def model_stride(model) -> int:
    """The largest stride of the model's feature maps: the product of the
    strides of a ``layer_config`` model's convs, 2 ** SOEMs for a
    DySOEM_SimFPN."""
    if hasattr(model, "tokens"):
        s = 1
        for tok in model.tokens:
            if tok[0] == "DyConv":
                s *= int(tok[3])
            elif not isinstance(tok[0], str):
                s *= int(tok[2])
        return s
    if hasattr(model, "soems"):
        return 2 ** len(model.soems)
    raise ValueError(f"no stride rule for {type(model).__name__}")


def row_band(sp_index: int, n_sp: int, height: int,
             stride: int = 1) -> range:
    """The rows of the image that rank ``sp_index`` of ``n_sp`` holds:
    contiguous bands of ``height / n_sp`` rows. ``height`` must be a
    multiple of ``n_sp * stride`` (``stride``: the model's largest)."""
    if height % (n_sp * stride):
        raise ValueError(
            f"sp: the image's {height} rows must be a multiple of sp "
            f"{n_sp} x the model's largest stride {stride} (each rank's "
            f"band must start on a row of every feature map); the port "
            f"refuses uneven bands, where GSPMD pads them")
    h = height // n_sp
    return range(sp_index * h, (sp_index + 1) * h)


def _rank_and_size(group):
    return dist.get_rank(group), dist.get_world_size(group)


def _gather(t: torch.Tensor, group) -> list:
    t = t.contiguous()
    parts = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return parts


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, top, bottom, group, dim):
        ctx.top, ctx.bottom, ctx.group, ctx.dim = top, bottom, group, dim
        r, n = _rank_and_size(group)
        h = x.shape[dim]
        if max(top, bottom) > h:
            raise ValueError(f"a halo of {top} + {bottom} rows needs a band "
                             f"of as many rows, got {h}")
        parts = _gather(torch.cat([x.narrow(dim, 0, bottom),
                                   x.narrow(dim, h - top, top)], dim), group)

        def zeros(k):
            shape = list(x.shape)
            shape[dim] = k
            return x.new_zeros(shape)

        above = parts[r - 1].narrow(dim, bottom, top) if r else zeros(top)
        below = (parts[r + 1].narrow(dim, 0, bottom) if r + 1 < n
                 else zeros(bottom))
        return torch.cat([above, x, below], dim)

    @staticmethod
    def backward(ctx, dy):
        top, bottom, dim = ctx.top, ctx.bottom, ctx.dim
        r, n = _rank_and_size(ctx.group)
        h = dy.shape[dim] - top - bottom
        parts = _gather(torch.cat([dy.narrow(dim, 0, top),
                                   dy.narrow(dim, top + h, bottom)], dim),
                        ctx.group)
        dx = dy.narrow(dim, top, h).clone()
        if r + 1 < n:   # the rank below's top halo is our last rows
            dx.narrow(dim, h - top, top).add_(parts[r + 1].narrow(dim, 0, top))
        if r:           # the rank above's bottom halo is our first rows
            dx.narrow(dim, 0, bottom).add_(parts[r - 1].narrow(dim, top,
                                                               bottom))
        return dx, None, None, None, None


def halo_exchange(x: torch.Tensor, top: int, bottom: int, group,
                  dim: int = -2) -> torch.Tensor:
    """``x`` (this rank's band, rows on ``dim``) with ``top`` rows of the
    rank above before it and ``bottom`` rows of the rank below after it;
    zeros where the band is at the image's edge. Differentiable. Every rank
    of ``group`` calls it with the same ``top`` and ``bottom``; a band
    without samples exchanges nothing (all ranks of an sp group hold the
    same samples)."""
    dim = dim % x.ndim
    if x.numel() == 0 or top == bottom == 0:
        shape = list(x.shape)
        shape[dim] += top + bottom
        return x.new_zeros(shape) if x.numel() == 0 else x
    return _HaloExchange.apply(x, top, bottom, group, dim)


def halo_for_conv(x: torch.Tensor, k: int, stride: int, padding: int,
                  sp_group, dim: int = 2) -> torch.Tensor:
    """The band ``x`` (rows on ``dim``) with the halo a k x k conv of
    ``stride`` and ``padding`` reads: ``padding`` rows from above and ``k -
    stride - padding`` from below; to be convolved without row padding. A
    1 x 1 kernel takes none (its band starts on a row of the stride)."""
    bottom = k - stride - padding
    if k == 1 and not padding:
        return x
    if bottom < 0:
        raise ValueError(f"no halo rule for a {k}x{k} conv of stride "
                         f"{stride} and padding {padding}")
    return halo_exchange(x, padding, bottom, sp_group, dim=dim)


def conv2d_rows(x: torch.Tensor, weight: torch.Tensor, bias=None,
                stride: int = 1, padding: int = 0, groups: int = 1,
                sp_group=None) -> torch.Tensor:
    """``F.conv2d(x, weight, bias, stride, padding, groups=groups)`` of NCHW
    ``x``, where ``x`` is a band of rows of ``sp_group``'s image: the halo
    rows are exchanged and the rows are not padded (see the module
    docstring)."""
    if sp_group is None:
        return F.conv2d(x, weight, bias, stride, padding, groups=groups)
    xh = halo_for_conv(x, weight.shape[-2], stride, padding, sp_group)
    return F.conv2d(xh, weight, bias, stride, (0, padding), groups=groups)


class _SpSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        g = dy.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def sp_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (``x`` as it is where
    the group is None), differentiable: every rank computes the same value
    from it, so the gradient of each rank's ``x`` is the sum of every
    rank's gradient of the result."""
    if group is None or x.numel() == 0:
        return x
    return _SpSum.apply(x, group)


def gather_rows(t: torch.Tensor, group, dim: int = -2) -> torch.Tensor:
    """The bands of every rank of ``group``, in rank order, joined on
    ``dim``: the inverse of ``row_band``'s split (not differentiated)."""
    if group is None:
        return t
    return torch.cat(_gather(t, group), dim=dim)


def set_sp_group(model, group) -> None:
    """Every module of ``model`` that convolves or pools over rows (those
    with an ``sp_group`` attribute) takes ``group``."""
    for m in model.modules():
        if hasattr(m, "sp_group"):
            m.sp_group = group


@contextlib.contextmanager
def sp_rows(model, group):
    """``set_sp_group(model, group)`` for the length of the block; the
    modules' groups are put back after it."""
    mods = [m for m in model.modules() if hasattr(m, "sp_group")]
    before = [m.sp_group for m in mods]
    for m in mods:
        m.sp_group = group
    try:
        yield
    finally:
        for m, g in zip(mods, before):
            m.sp_group = g
