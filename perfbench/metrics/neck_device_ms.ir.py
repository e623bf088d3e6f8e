"""Device ms a call of the program's ``neck`` span (DySOEM_SimFPN's simplified
FPN and heads): the union of the device intervals it launched over the
profiled slice's calls (``spans.py``)."""

from perfbench.spans import device_ms


def read(ctx):
    return device_ms(ctx, "neck")
