"""Spans and counters inside the detector: which part of a call the host's
and the device's time belongs to.

    from uavdet_tpu_torch import tracing

    with tracing.collect() as t:
        detect(frames)
    t.spans    # [Span(name, request, parent, start_ns, end_ns, frames), ...]
    t.counts   # {"detect": {"calls": 1, "frames": 16}, "stem": ..., ...}

The detector marks its sections with ``span(name)``: ``detect`` around each
call of a detector (``frames`` its batch), and inside it ``stem`` and
``tail`` (DyYOLO: the stem kernels with their weight mixing, then the rest
of the model and its heads), ``front``, ``soem`` (one per SOEM) and
``neck`` (DySOEM_SimFPN), and ``post`` (decode, top-k, threshold, NMS and
the gathers of the fixed-shape result). Work in no section, such as the
resize of ``preprocess`` or a BaselineModel's whole forward, is
``detect``'s own time.

Tracing is off unless ``collect`` is on: ``span`` then returns one shared
object that does nothing, after a single check of a module-level flag. On,
each span appends one record to a list of its thread: its name, the
request id of the call it belongs to (one per outermost span, from a
process-wide counter), the index of its parent span in ``spans`` (-1 for
none) and its start and end on ``time.perf_counter_ns()``. While a
``torch.profiler`` records, a span also opens the profiler range
``uavdet.<name>`` (``torch.profiler.record_function``), so the sections
appear in the profiler's trace on the clock of the device's kernels,
copies and sets; the Trainer's ``profiler`` option shows them too when
run inside ``collect``. While ``torch.compile`` or ``torch.export`` traces
(``torch.compiler.is_compiling()``), a span does nothing, so an exported
detector is the same program with tracing on or off.
"""

import contextlib
import itertools
import threading
import time
from typing import NamedTuple

import torch


class Span(NamedTuple):
    """One section of one call. ``end_ns`` is None for a span of another
    thread still open when ``collect`` ended."""

    name: str
    request: int
    parent: int
    start_ns: int
    end_ns: int | None
    frames: int | None


class Trace(NamedTuple):
    """What ``collect`` gathered: every span, and per span name its
    ``calls`` and the ``frames`` its spans gave."""

    spans: list
    counts: dict


_OFF = contextlib.nullcontext()   # the span of tracing off, shared
_requests = itertools.count(1)   # next() on it is atomic under the GIL
_local = threading.local()
_active = None   # the open collect's list of _Thread records, or None: off


class _Thread:
    """One thread's records in one ``collect``, and its stack of open
    spans."""

    def __init__(self, run: list):
        self.run, self.records, self.stack = run, [], []
        run.append(self)


class _Span:
    __slots__ = ("thread", "name", "frames", "index", "range")

    def __init__(self, thread: _Thread, name: str, frames):
        self.thread, self.name, self.frames = thread, name, frames
        self.range = None

    def __enter__(self):
        t = self.thread
        parent = t.stack[-1] if t.stack else -1
        request = t.records[parent][1] if parent >= 0 else next(_requests)
        self.index = len(t.records)
        t.stack.append(self.index)
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function("uavdet." + self.name)
            self.range.__enter__()
        t.records.append([self.name, request, parent, time.perf_counter_ns(),
                          None, self.frames])
        return self

    def __exit__(self, *exc):
        t = self.thread
        t.records[self.index][4] = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        t.stack.pop()
        return False


def span(name: str, frames: int | None = None):
    """A context manager around one section of a call: ``name`` is the
    section, ``frames`` the frames it works on where it counts them."""
    run = _active
    if run is None or torch.compiler.is_compiling():
        return _OFF
    thread = getattr(_local, "thread", None)
    if thread is None or thread.run is not run:
        thread = _local.thread = _Thread(run)
    return _Span(thread, name, frames)


@contextlib.contextmanager
def collect():
    """Tracing on inside; the ``Trace`` it yields is filled on exit, when
    tracing goes off again. Calls do not nest."""
    global _active
    if _active is not None:
        raise RuntimeError("tracing.collect() is already on; calls do not "
                           "nest")
    run, out = [], Trace([], {})
    _active = run
    try:
        yield out
    finally:
        _active = None
        for thread in run:
            base = len(out.spans)
            for name, request, parent, start, end, frames in thread.records:
                out.spans.append(Span(name, request,
                                      parent + base if parent >= 0 else -1,
                                      start, end, frames))
                count = out.counts.setdefault(name, {"calls": 0, "frames": 0})
                count["calls"] += 1
                count["frames"] += frames or 0
