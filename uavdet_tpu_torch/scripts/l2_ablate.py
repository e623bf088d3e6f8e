#!/usr/bin/env python3
"""Kernel B (``ops/stem.py:stem_l2``) stage by stage, on one NVIDIA GPU.

Port of the TPU harness ``scripts/l2_ablate.py``: the kernel is cut off
after successive stages, each still storing every output tile (a cheap
function of what the stage produced, so that the compiler cannot drop the
work), and each variant is timed with CUDA events. The ladder is the one
``csrc/stem_l2.cu`` has on this card, cumulative:

  0 store     write the output tiles only
  1 +k2       + stage K2[b] in shared memory as bf16
  2 +window   + each tile's 33 x 33 x 32 input window, copied with cp.async
              into one of two buffers while the tile before it is in work
  3 +mma      + the tap loop on the tensor cores (mma.sync m16n8k16)
  4 full      + bias, SiLU: kernel B itself

The TPU harness's roll, selection-matmul and quad-parity stages time layout
steps of Mosaic that this kernel does not have. The first line printed is
the card's name and power limit; a "program" in the per-program time is one
16 x 16 output tile.

Usage: python3 -m uavdet_tpu_torch.scripts.l2_ablate [--batch 16]
       [--input 640] [--iters 30] [--stages 3,full]
"""

import argparse

import numpy as np

WARMUP = 3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--input", type=int, default=640)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--stages", type=str, default="",
                    help="comma list of stage numbers or names, e.g. "
                         "'3,full' (default: all)")
    args = ap.parse_args(argv)

    import torch

    from ..ops.stem import L2_STAGES, stem_l2_stage
    from ..utils.timing import card_line, cuda_ms

    if not torch.cuda.is_available():
        raise SystemExit("l2_ablate needs a CUDA device; none is visible")
    print(card_line(), flush=True)

    b, s = args.batch, args.input
    rng = np.random.default_rng(0)
    a1 = torch.from_numpy(
        (rng.normal(size=(b, s, s, 32)) * 0.1).astype(np.float32)
    ).to("cuda", torch.bfloat16)
    k2 = torch.from_numpy(
        (rng.normal(size=(b, 64, 289)) * 0.05).astype(np.float32)
    ).to("cuda", torch.bfloat16)
    half = (s + 1) // 2
    n_prog = b * -(-half // 16) * -(-half // 16)

    names = {"store": "store floor", "+k2": "+K2[b] staged in shared memory",
             "+window": "+input windows, double-buffered cp.async",
             "+mma": "+tap loop (tensor cores)",
             "full": "FULL (bias + SiLU epilogue)"}
    stages = list(enumerate(L2_STAGES))
    if args.stages:
        picked = [p.strip() for p in args.stages.split(",")]
        stages = [(i, n) for i, n in stages if str(i) in picked or n in picked]
    for i, name in stages:
        ms = cuda_ms(lambda: stem_l2_stage(a1, k2, name), args.iters, WARMUP)
        print(f"stage {i!s:>4} {names[name]:<46s} "
              f"{ms:8.3f} ms  ({ms / n_prog * 1e3:6.3f} us/prog)",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
