"""Device ms a call of the program's ``fuse`` span (RTMUAVDet's cross-scale
fusion (the bilinear upsample, its 3x3 conv and cat; the stride-2 downsample
and cat), both together): the union of the device intervals it launched over
the profiled slice's calls (``spans.py``)."""

from perfbench.spans import device_ms


def read(ctx):
    return device_ms(ctx, "fuse")
