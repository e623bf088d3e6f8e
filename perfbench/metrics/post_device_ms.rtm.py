"""Device ms a call of the program's ``post`` span on RTMUAVDet (its
decoded heads to pixels, the top 512 of each frame's 96,000 candidates, NMS
by kernel C and the gathers of the fixed-shape result): the union of the
device intervals it launched over the profiled slice's calls
(``spans.py``)."""

from perfbench.spans import device_ms


def read(ctx):
    return device_ms(ctx, "post")
