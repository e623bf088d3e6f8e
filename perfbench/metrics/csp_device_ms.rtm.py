"""Device ms a call of the program's ``csp`` span (each of RTMUAVDet's two
MDyCSP modules (base conv, split, MDyConv, transitions), all together): the
union of the device intervals it launched over the profiled slice's calls
(``spans.py``)."""

from perfbench.spans import device_ms


def read(ctx):
    return device_ms(ctx, "csp")
