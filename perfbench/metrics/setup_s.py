"""Seconds from the start of the run (before ``import torch``) to the
window: imports, weights, the program's build, inputs and the warm-up of
every shape the mix uses (the first run in a checkout adds the build of the
program's kernels)."""

from perfbench.readers import setup as read  # noqa: F401
