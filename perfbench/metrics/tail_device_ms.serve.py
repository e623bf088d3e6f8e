"""Device ms a call of the program's ``tail`` span (DyYOLO's eager rest of the
model after the stem, and its heads): the union of the device intervals it
launched over the profiled slice's calls (``spans.py``)."""

from perfbench.spans import device_ms


def read(ctx):
    return device_ms(ctx, "tail")
