"""Device ms a call of the program's ``front`` span (DySOEM_SimFPN's input stem
(conv, BN, SiLU)): the union of the device intervals it launched over the
profiled slice's calls (``spans.py``)."""

from perfbench.spans import device_ms


def read(ctx):
    return device_ms(ctx, "front")
