#!/usr/bin/env python3
"""The fused post-stem block kernel (``ops/block.py:post_stem_block``) stage
by stage, on one NVIDIA GPU.

Port of the TPU harness ``scripts/block_ablate.py``: cumulative variants of
the kernel, each its own instantiation, each still storing every output
tile (of what the stage produced last), timed with CUDA events. The stages
are the ones ``csrc/post_stem_block.cu`` has on this card:

  load   stage x's 19 x 19 window, w1, k2 and the biases in shared memory
  dot1   + the 1x1 64->32 conv + leaky + mask: z
  dot2   + the 3x3 32->64 conv + leaky + residual + mask: y
  full   + k3 streamed tap by tap and the 3x3 stride-2 64->128 conv + leaky

The TPU harness's mask, tap-staging, fold and roll stages and its candidate
fixes time layout steps of Mosaic that this kernel does not have. The first
line printed is the card's name and power limit; a "program" in the
per-program time is one 8 x 8 output tile.

Usage: python3 -m uavdet_tpu_torch.scripts.block_ablate [--batch 16]
       [--input 640] [--iters 20] [--only dot2,full]
"""

import argparse

import numpy as np

WARMUP = 3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--input", type=int, default=640,
                    help="the detector's input size; the block sees half")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", type=str, default="",
                    help="comma list of stage names (default: all)")
    args = ap.parse_args(argv)

    import torch

    from ..ops.block import BLOCK_STAGES, post_stem_block_stage
    from ..utils.timing import card_line, cuda_ms

    if not torch.cuda.is_available():
        raise SystemExit("block_ablate needs a CUDA device; none is visible")
    print(card_line(), flush=True)

    b = args.batch
    h2 = w = args.input // 2
    rng = np.random.default_rng(0)

    def operand(shape, scale):
        return torch.from_numpy(
            (rng.normal(size=shape) * scale).astype(np.float32)
        ).to("cuda", torch.bfloat16)

    x = operand((b, h2, w, 64), 1.0)
    w1 = operand((32, 65), 0.1)
    k2 = operand((64, 289), 0.1)
    k3 = operand((128, 577), 0.1)
    n_prog = b * -(-((h2 + 1) // 2) // 8) * -(-((w + 1) // 2) // 8)

    stages = list(BLOCK_STAGES)
    if args.only:
        keep = set(args.only.split(","))
        stages = [s for s in stages if s in keep]
    for name in stages:
        ms = cuda_ms(lambda: post_stem_block_stage(x, w1, k2, k3, name),
                     args.iters, WARMUP)
        print(f"{name:<28s} {ms:8.3f} ms   "
              f"{ms / n_prog * 1e3:7.3f} us/program", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
