"""Device ms a call of the program's ``soem`` span (DySOEM_SimFPN's three SOEMs
together (space-to-depth, attention, kernel D)): the union of the device
intervals it launched over the profiled slice's calls (``spans.py``)."""

from perfbench.spans import device_ms


def read(ctx):
    return device_ms(ctx, "soem")
