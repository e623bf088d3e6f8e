"""Host ms a call of the program's ``stem`` span (DyYOLO's stem: the DyConv
attention, the weight mixing and fold, kernels A and B), inclusive of its
children: the median over the host slice's calls, each after a synchronize
(``spans.py``)."""

from perfbench.spans import host_ms


def read(ctx):
    return host_ms(ctx, "stem")
