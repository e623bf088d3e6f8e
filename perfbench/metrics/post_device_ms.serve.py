"""Device ms a call of the program's ``post`` span (decode, global top-k,
threshold, NMS (kernel C) and the gathers of the fixed-shape result): the
union of the device intervals it launched over the profiled slice's calls
(``spans.py``)."""

from perfbench.spans import device_ms


def read(ctx):
    return device_ms(ctx, "post")
