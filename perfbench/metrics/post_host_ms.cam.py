"""Host ms a call of the program's ``post`` span (decode, global top-k,
threshold, NMS (kernel C) and the gathers of the fixed-shape result),
inclusive of its children: the median over the host slice's calls, each
after a synchronize (``spans.py``)."""

from perfbench.spans import host_ms


def read(ctx):
    return host_ms(ctx, "post")
