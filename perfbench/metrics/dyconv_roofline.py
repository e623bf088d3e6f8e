"""Kernel D (``dyconv_kernel``): each SOEM of DySOEM_SimFPN, the 3x3 conv
of the space-to-depth'd bf16 map (4C -> 2C channels) with the per-sample
mixed kernel, BN folded, SiLU, bf16 out. Three launches a call, one per
SOEM: the sum of their floors over their device time per call, in
percent."""

from perfbench.readers import roofline


def launches(batch, size, soems=3, stem=32):
    out, h, c = [], size, stem
    for _ in range(soems):
        h, cin = h // 2, 4 * c
        c = cin // 2
        pixels = batch * h * h
        flops = 2.0 * pixels * c * cin * 9
        nbytes = 2.0 * pixels * cin + 2.0 * pixels * c \
            + 2.0 * batch * 9 * cin * c
        out.append((flops, nbytes))
    return out


def read(ctx):
    t = ctx["traffic"]
    return roofline(ctx, "dyconv_kernel",
                    launches(t["batch"], t["size"],
                             len(ctx["config"]["hparams"]["num_dy_conv"])))
