"""Kernel A (``stem_l1_kernel``): DyYOLO's first DyConv, 3 -> 32 3x3 on
uint8 frames with the mixed, BN-folded kernel, SiLU, bf16 out. One launch
a call: its floor over its device time per launch, in percent."""

from perfbench.readers import roofline


def launches(batch, size):
    pixels = batch * size * size
    flops = 2.0 * pixels * 32 * 27
    nbytes = pixels * 3 + 2.0 * pixels * 32 + 2.0 * batch * 32 * 28
    return [(flops, nbytes)]


def read(ctx):
    t = ctx["traffic"]
    return roofline(ctx, "stem_l1_kernel", launches(t["batch"], t["size"]))
