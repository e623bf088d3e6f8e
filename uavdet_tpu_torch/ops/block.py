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
"""

import torch
import torch.nn.functional as F

from .. import kernels

_BF16 = torch.bfloat16
LEAKY_SLOPE = 0.1
# The kernel's stage ladder: each stage adds one step to the one before it.
BLOCK_STAGES = ("load", "dot1", "dot2", "full")
BLOCK_TOKENS = (("B", 1), (128, 3, 2))


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
    (the CUDA caller must disable TF32 for cuDNN to keep them f32)."""
    xf = x.to(_BF16).float().permute(0, 3, 1, 2)
    z = _conv(xf, w1, 1, 1).to(_BF16).float()
    y = (_conv(z, k2, 3, 1) + xf).to(_BF16).float()
    out = _conv(y, k3, 3, 2).to(_BF16)
    return out.permute(0, 2, 3, 1).contiguous()


def _pack(k_aug: torch.Tensor):
    """(O, K + 1) -> the kernel's operands: [K][O] bf16 and the bias (O,) as
    f32 of its bf16 value."""
    kq = k_aug.to(_BF16)
    return kq[:, :-1].t().contiguous(), kq[:, -1].float().contiguous()


def _post_stem_block_cuda(x, w1, k2, k3, stage: int) -> torch.Tensor:
    b, h, w, c = x.shape
    dev = x.device
    if c != 64 or x.dtype != _BF16:
        raise ValueError(f"x: expected (B, H, W, 64) bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    for name, t, shape in (("w1", w1, (32, 65)), ("k2", k2, (64, 289)),
                           ("k3", k3, (128, 577))):
        if (tuple(t.shape) != shape or t.device != dev
                or t.dtype not in (torch.float32, _BF16)):
            raise ValueError(f"{name}: expected {shape} float32 or bfloat16 "
                             f"on {dev}, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned (the kernel copies "
                         "pixels as 16-byte vectors)")
    (w1t, b1), (k2t, b2), (k3t, b3) = _pack(w1), _pack(k2), _pack(k3)
    out = torch.empty((b, (h + 1) // 2, (w + 1) // 2, 128), dtype=_BF16,
                      device=dev)
    kernels.POST_STEM_BLOCK(
        x.data_ptr(), w1t.data_ptr(), k2t.data_ptr(), k3t.data_ptr(),
        b1.data_ptr(), b2.data_ptr(), b3.data_ptr(), out.data_ptr(), b, h, w,
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
    (128, 577) -> (B, ceil(H/2), ceil(W/2), 128) bf16 NHWC."""
    return post_stem_block_stage(x, w1, k2, k3, "full")
