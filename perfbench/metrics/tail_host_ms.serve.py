"""Host ms a call of the program's ``tail`` span (DyYOLO's eager rest of the
model after the stem, and its heads), inclusive of its children: the median
over the host slice's calls, each after a synchronize (``spans.py``)."""

from perfbench.spans import host_ms


def read(ctx):
    return host_ms(ctx, "tail")
