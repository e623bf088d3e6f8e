"""Device ms a call of the program's ``mdy`` span (the three parallel MDyConvs
of each MDyEncoder, their cat and the residual add, both encoders together):
the union of the device intervals it launched over the profiled slice's calls
(``spans.py``)."""

from perfbench.spans import device_ms


def read(ctx):
    return device_ms(ctx, "mdy")
