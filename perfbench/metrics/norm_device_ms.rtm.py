"""Device ms a call of the program's ``norm`` span (the four GroupNorm(1)s of
RTMUAVDet's two MDyEncoders, all together): the union of the device intervals
it launched over the profiled slice's calls (``spans.py``)."""

from perfbench.spans import device_ms


def read(ctx):
    return device_ms(ctx, "norm")
