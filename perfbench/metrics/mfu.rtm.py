"""Percent of the card's bf16 peak reached by the served forward: the
configuration's FLOPs per frame x the unprofiled window's frames per
second."""

from perfbench.readers import mfu


def read(ctx):
    return mfu(ctx, 1.0)
