"""Kernel B (``stem_l2_kernel``): DyYOLO's second DyConv, 32 -> 64 3x3
stride 2 on kernel A's bf16 output with the mixed, BN-folded kernel, SiLU,
bf16 out. One launch a call: its floor over its device time per launch, in
percent."""

from perfbench.readers import roofline


def launches(batch, size):
    out = batch * ((size + 1) // 2) ** 2
    flops = 2.0 * out * 64 * 288
    nbytes = 2.0 * batch * size * size * 32 + 2.0 * out * 64 \
        + 2.0 * batch * 64 * 289
    return [(flops, nbytes)]


def read(ctx):
    t = ctx["traffic"]
    return roofline(ctx, "stem_l2_kernel", launches(t["batch"], t["size"]))
