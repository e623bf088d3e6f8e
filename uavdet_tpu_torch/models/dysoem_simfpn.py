"""DySOEM_SimFPN: dynamic small-object-enhancement backbone + simplified FPN.

Port of ``uavdet_tpu/models/dysoem_simfpn.py`` (config
``conf/model/dy-soem_fpn.yaml``), the unfolded model: the TPU layout
rewrites (``fold_input_stem``, ``fold_soem_neck``, the fused
space-to-depth-as-6x6-conv) are not ported.

  ``InputStemLayer``   3 -> 32 1x1 ConvModule
  ``DynamicSOEM``      space-to-depth (x2) -> per-sample attention over E
                       expert 3x3 convs -> BN + SiLU, computed as ONE conv
                       with the attention-mixed kernel (conv is linear in
                       the kernel; the biases mix the same way)
  ``SimplifiedFPN``    3-level bidirectional fusion neck
  ``YOLOHead``         on the three neck maps, highest resolution first

Module names follow the flax tree where flax names its scopes
(``input_stem``, ``soem_{i}``, ``attn_fc1``, ``attn_fc2``, ``experts``,
``neck`` and its convs) and PyTorch's habit elsewhere (``conv``, ``bn``);
``utils/weights.py`` maps a flax tree onto them. The SOEMs pass NHWC tensors
(the layout of the dyconv kernel); the stem, neck and head are NCHW views of
the same memory (channels_last).
"""

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dyconv import dyconv, mixed_bias, mixed_kernel, parity_sums
from ..parallel.experts import mix_slices
from ..parallel.spatial import halo_for_conv, sp_sum
from .layers import BatchNorm2d, ConvModule, YOLOHead, global_mean


class InputStemLayer(ConvModule):
    """1x1 ConvModule on the frames."""

    def __init__(self, out_channels: int = 32, in_channels: int = 3):
        super().__init__(in_channels, out_channels, 1)


class AdaptiveStemLayer(nn.Module):
    """Separate stems for 1-channel IR and 3-channel RGB inputs (NCHW)."""

    def __init__(self, out_channels: int = 32):
        super().__init__()
        self.gray_conv = ConvModule(1, out_channels, 1)
        self.rgb_conv = ConvModule(3, out_channels, 1)

    def forward(self, x):
        return (self.gray_conv if x.shape[1] == 1 else self.rgb_conv)(x)


def space_to_depth(x: torch.Tensor, k: int = 2) -> torch.Tensor:
    """NHWC (B, H, W, C) -> (B, H/k, W/k, k*k*C): pixel phase (pi, pj) of
    each k x k cell goes to channels [(pi*k + pj)*C, (pi*k + pj + 1)*C). A
    copy; the result is contiguous."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // k, k, w // k, k, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // k, w // k, k * k * c)


def pooled_from_sums(out: torch.Tensor, sums: torch.Tensor,
                     n_sp: int = 1) -> torch.Tensor:
    """The channel means of ``space_to_depth(out)`` (B, 4 Co), in out's
    dtype, from the (B, 2, 2, Co) parity-split sums of out (B, H, W, Co): the
    ``pooled`` of the SOEM that consumes ``out``. Under ``sp`` ``out`` is one
    of ``n_sp`` bands and ``sums`` the whole image's."""
    b, h, w, c = out.shape
    return (sums.reshape(b, 4 * c)
            / float(n_sp * (h // 2) * (w // 2))).to(out.dtype)


def _column_parity_sums(row: torch.Tensor) -> torch.Tensor:
    """(B, W, Co) one row -> (B, 2, Co) f32 sums by column parity."""
    r = row.float()
    return torch.stack([r[:, 0::2].sum(1), r[:, 1::2].sum(1)], dim=1)


def own_rows_sums(sums: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Kernel D's ``emit_gap`` sums (B, 2, 2, Co) of a band convolved with
    one halo row on each side (``out``: its h + 2 output rows, the first
    and last the halo's) -> the sums of the band's own h rows, by global
    row parity. The band starts on an even global row, so the kernel's
    first row (the halo above) has odd global parity and the parities of
    the rest are the kernel's flipped."""
    own = sums.flip(1)
    top = _column_parity_sums(out[:, 0])
    bottom = _column_parity_sums(out[:, -1])
    return torch.stack([own[:, 0] - bottom, own[:, 1] - top], dim=1)


class Experts(nn.Module):
    """The E expert convs of a SOEM in one tensor, in the flax layout:
    ``kernel`` (ks, ks, C_in, E*Co) HWIO with the experts stacked
    expert-major on the last axis (column ``e*Co + o`` is output channel
    ``o`` of expert ``e``), and ``bias`` (E*Co,) in the same order."""

    def __init__(self, ksize: int, c_in: int, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(ksize, ksize, c_in, features))
        self.bias = nn.Parameter(torch.empty(features))


class DynamicSOEM(nn.Module):
    """Small-Object Enhancement Module, NHWC in and out.

    In eval mode a bf16 module with 3x3 experts goes through
    ``ops.dyconv.dyconv`` (kernel D on a CUDA tensor, its plain version on
    the CPU): bf16 operands, f32 sums, inference BN folded into the
    kernel's affine. The kernel is bf16-only and has no backward, as in the
    JAX package, so it claims nothing else: in training, whatever the dtype
    and device, and in eval mode for any other dtype, the same mixed-kernel
    conv runs in the module's dtype through PyTorch's grouped conv
    (groups = batch), without rounding, with BatchNorm in its own mode. A
    float32 conv on the card follows ``torch.backends.cudnn.allow_tf32``.
    Off the CPU a bf16 module in eval mode with other experts than 3x3
    raises instead of giving way to a library conv.

    ``pooled``: the attention's input, the channel means of the
    space-to-depth'd map (B, 4C), when the producer of ``x`` already has
    them. ``sp_group`` (``parallel.spatial``): ``x`` is a band of the
    image's rows; the pool is the whole image's, the conv (the kernel's
    too) takes one halo row on each side and its output is cropped, and the
    ``emit_gap`` sums are the band's own rows' summed over the group. Where
    the experts are ``ep`` slices (``parallel.experts``) the per-sample
    kernel and bias are mixed over the ``ep`` group. ``emit_gap``: also return the f32 sums of the output by (row
    parity, column parity, channel), (B, 2, 2, Co), from which the next
    SOEM's ``pooled`` follows without reading the map again. ``conv`` is
    the kernel; a caller that holds it against its plain version passes
    ``dyconv_plain``.
    """

    sp_group = None

    def __init__(self, in_channels: int, num_dy_conv: int = 3,
                 dy_kernel_size: int = 3, downsample_factor: int = 2,
                 reduction_ratio: int = 2):
        super().__init__()
        self.downsample_factor = downsample_factor
        self.num_dy_conv = num_dy_conv
        self.dy_kernel_size = dy_kernel_size
        in_attn = downsample_factor ** 2 * in_channels
        self.out_channels = in_attn // reduction_ratio
        hidden = max(1, in_attn // 4)
        self.attn_fc1 = nn.Linear(in_attn, hidden)
        self.attn_fc2 = nn.Linear(hidden, num_dy_conv)
        self.experts = Experts(dy_kernel_size, in_attn,
                               num_dy_conv * self.out_channels)
        self.bn = BatchNorm2d(self.out_channels)

    def attention_weights(self, pooled: torch.Tensor,
                          attn_temp: float) -> torch.Tensor:
        """(B, 4C) channel means -> (B, E) softmax weights, at least f32."""
        a = self.attn_fc2(F.relu(self.attn_fc1(pooled)))
        acc = torch.promote_types(a.dtype, torch.float32)
        return torch.softmax(a.to(acc) / attn_temp, dim=-1)

    def mixed(self, attn: torch.Tensor, dtype=None):
        """(B, E) attentions -> the per-sample kernel (B, ks*ks, C, Co) and
        bias (B, Co), from the experts cast to ``dtype`` (None: their
        own)."""
        kernel, bias = self.experts.kernel, self.experts.bias
        if dtype is not None and getattr(kernel, "ep_slice", None) is None:
            kernel, bias = kernel.to(dtype), bias.to(dtype)
        oc = self.out_channels
        if getattr(kernel, "ep_slice", None) is None:
            return mixed_kernel(kernel, attn, oc), mixed_bias(bias, attn, oc)
        k, bias = mix_slices(attn, [kernel, bias])   # k (B, Co, ks, ks, C)
        b, _, kh, kw, c = k.shape
        return k.permute(0, 2, 3, 4, 1).reshape(b, kh * kw, c, oc), bias

    def forward(self, x, attn_temp: float = 1.0, pooled=None,
                emit_gap: bool = False, conv=dyconv):
        f = space_to_depth(x, self.downsample_factor)
        b, h, w, c = f.shape
        oc, ks = self.out_channels, self.dy_kernel_size
        group = self.sp_group
        if pooled is None:
            if group is None:
                acc = torch.promote_types(f.dtype, torch.float32)
                pooled = f.mean(dim=(1, 2), dtype=acc).to(f.dtype)
            else:
                pooled = global_mean(f, (1, 2), group)
        attn = self.attention_weights(pooled, attn_temp)
        if (f.dtype == torch.bfloat16 and not self.training and ks != 3
                and f.device.type != "cpu"):
            raise RuntimeError(
                f"DynamicSOEM serves bfloat16 on {f.device} through the "
                f"dyconv kernel only, which takes 3x3 experts; got {ks}x{ks}")
        if group is not None:
            f = halo_for_conv(f, ks, 1, ks // 2, group, dim=1)
        if f.dtype == torch.bfloat16 and ks == 3 and not self.training:
            bn = self.bn
            mul = bn.weight.float() * torch.rsqrt(bn.running_var.float()
                                                  + bn.eps)
            k, bias = self.mixed(attn, torch.float32)
            add = (bn.bias.float() - bn.running_mean.float() * mul)[None] \
                + bias.float() * mul
            res = conv(f, k.float().to(torch.bfloat16), mul, add,
                       emit_gap=emit_gap)
            if group is None:
                return res
            out, sums = res if emit_gap else (res, None)
            y = out[:, 1:-1]
            if emit_gap:
                return y, sp_sum(own_rows_sums(sums, out), group)
            return y
        attn = attn.to(f.dtype)
        k, bias = self.mixed(attn)   # (B, ks*ks, C, Co), (B, Co)
        fh = f.shape[1]
        y = F.conv2d(f.permute(0, 3, 1, 2).reshape(1, b * c, fh, w),
                     k.permute(0, 3, 2, 1).reshape(b * oc, c, ks, ks),
                     bias.reshape(b * oc),
                     padding=(0 if group is not None else ks // 2, ks // 2),
                     groups=b)
        y = F.silu(self.bn(y.reshape(b, oc, h, w))).permute(0, 2, 3, 1)
        if not emit_gap:
            return y
        return y, sp_sum(parity_sums(y), group)


class SimplifiedFPN(nn.Module):
    """3-level bidirectional fusion neck, NCHW. x0 is the highest
    resolution, x2 the lowest. The reference's center node adds x1 twice;
    kept."""

    def __init__(self, channels: Sequence[int]):
        super().__init__()
        c0, c1, c2 = channels
        self.x2_in_down = nn.Conv2d(c2, c1, 1)
        self.center_down = nn.Conv2d(c1, c0, 1)
        self.x0_out_up = nn.Conv2d(c0, c1, 1, stride=2)
        self.x1_out_up = nn.Conv2d(c1, c2, 1, stride=2)
        self.x0_conv_out = ConvModule(c0, c0, 3, padding=1)
        self.x1_conv_out = ConvModule(c1, c1, 3, padding=1)
        self.x2_conv_out = ConvModule(c2, c2, 3, padding=1)

    def forward(self, f_maps):
        x0, x1, x2 = f_maps

        def up2(x):
            return F.interpolate(x, scale_factor=2, mode="nearest")

        # the 1x1 convs run before the upsampling: they commute with it
        center = x1 + up2(self.x2_in_down(x2)) + x1
        x0 = x0 + up2(self.center_down(center))
        x1 = center + self.x0_out_up(x0)
        x2 = x2 + self.x1_out_up(x1)
        return (self.x0_conv_out(x0), self.x1_conv_out(x1),
                self.x2_conv_out(x2))


class DySOEM_SimFPN(nn.Module):
    """Stem -> 3 x DynamicSOEM -> SimplifiedFPN -> YOLOHead.

    Channels 32 -> [64, 128, 256]; the heads come highest resolution first,
    at strides 2, 4 and 8. Each SOEM but the last also emits the
    parity-split channel sums of its output, and the next SOEM pools from
    those instead of reading its input map again.
    """

    def __init__(self, stem_out_channels: int = 32,
                 num_dy_conv: Sequence[int] = (3, 3, 3),
                 dy_kernel_size: Sequence[int] = (3, 3, 3),
                 attn_temperature: float = 30.0, n_anchors: int = 3,
                 in_channels: int = 3):
        super().__init__()
        if len(num_dy_conv) != len(dy_kernel_size):
            raise ValueError("num_dy_conv and dy_kernel_size differ in length")
        self.attn_temperature = float(attn_temperature)
        self.n_soem = len(num_dy_conv)
        self.input_stem = InputStemLayer(stem_out_channels, in_channels)
        c = stem_out_channels
        channels = []
        for i, (e, ks) in enumerate(zip(num_dy_conv, dy_kernel_size)):
            soem = DynamicSOEM(c, num_dy_conv=e, dy_kernel_size=ks)
            self.add_module(f"soem_{i}", soem)
            c = soem.out_channels
            channels.append(c)
        self.neck = SimplifiedFPN(channels)
        self.yolo_head = YOLOHead(channels, n_anchors)

    @property
    def soems(self):
        return [getattr(self, f"soem_{i}") for i in range(self.n_soem)]

    @property
    def dtype(self) -> torch.dtype:
        return next(self.parameters()).dtype

    def front(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) NHWC frames -> the input stem's output, NHWC."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)   # NCHW view of NHWC memory
        return self.input_stem(x).permute(0, 2, 3, 1)

    def soem_step(self, i: int, x: torch.Tensor, pooled=None, conv=dyconv):
        """SOEM ``i`` on its input x (NHWC) and ``pooled`` (None for the
        first) -> (its output, the next SOEM's ``pooled`` from this one's
        ``emit_gap`` sums; None after the last)."""
        soem = self.soems[i]
        if i + 1 == self.n_soem:
            return soem(x, self.attn_temperature, pooled=pooled,
                        conv=conv), None
        x, sums = soem(x, self.attn_temperature, pooled=pooled,
                       emit_gap=True, conv=conv)
        group = soem.sp_group
        n_sp = 1 if group is None else torch.distributed.get_world_size(group)
        return x, pooled_from_sums(x, sums, n_sp)

    def neck_head(self, feats) -> list:
        """The SOEMs' outputs (NHWC), highest resolution first -> one
        DetectionResults per head."""
        return self.yolo_head(self.neck([f.permute(0, 3, 1, 2)
                                         for f in feats]))

    def forward(self, x: torch.Tensor, conv=dyconv):
        """x: (B, H, W, 3) NHWC frames in [0, 1], H and W multiples of 8.
        -> one DetectionResults per head. ``conv``: see DynamicSOEM. The
        steps are ``front``, ``soem_step`` per SOEM and ``neck_head``, which
        ``scripts/cfg3_section_probe.py`` times one by one."""
        x, pooled = self.front(x), None
        feats = []
        for i in range(self.n_soem):
            x, pooled = self.soem_step(i, x, pooled, conv)
            feats.append(x)
        return self.neck_head(feats)
