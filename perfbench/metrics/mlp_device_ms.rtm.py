"""Device ms a call of the program's ``mlp`` span (the channel MLPs of
RTMUAVDet's two MDyEncoders (1x1 conv, tanh-GELU, 1x1 conv), both together):
the union of the device intervals it launched over the profiled slice's calls
(``spans.py``)."""

from perfbench.spans import device_ms


def read(ctx):
    return device_ms(ctx, "mlp")
