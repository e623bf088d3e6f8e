"""Spans and counters inside the detector: which part of a call the host's
and the device's time belongs to.

    from uavdet_tpu_torch import tracing

    with tracing.collect() as t:
        detect(frames)
    t.spans    # [Span(name, request, parent, start_ns, end_ns, frames), ...]
    t.counts   # {"detect": {"calls": 1, "frames": 16}, "stem": ...,
               #  "graph_replay": {"calls": 1, "frames": 16}, ...}

The detector marks its sections with ``span(name)``: ``detect`` around each
call of a detector (``frames`` its batch), and inside it ``stem`` and
``tail`` (DyYOLO: the stem kernels with their weight mixing, then the rest
of the model and its heads), ``front``, ``soem`` (one per SOEM) and
``neck`` (DySOEM_SimFPN), ``stem``, ``csp``, ``fuse``, ``norm``, ``mdy``,
``mlp`` and ``head`` (RTMUAVDet, ``models/rtm_uav_det.py``), and ``post``
(decode, top-k, threshold, NMS and the gathers of the fixed-shape result).
Work in no section, such as the resize of ``preprocess`` or a
BaselineModel's whole forward, is ``detect``'s own time.

Tracing is off unless ``collect`` is on: ``span`` then returns one shared
object that does nothing, after a single check of a module-level flag
(which a capture cut at the spans, below, also sets). On,
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

**Under CUDA graphs.** The one serving detect (``inference._serve``,
behind ``make_detector`` and ``make_rtm_detector``) on a card captures a
call as CUDA graphs cut at the spans (``cut_at_spans``): one graph per
section, in the order the call ran them, and one for each stretch of
``detect``'s own work that launched something. A replayed call opens
``detect`` as before and then one span per replayed section graph, around
that graph's launch (``detect``'s own graphs are replayed in ``detect``
itself): the same names and the same tree as an eager call, one record per
replayed segment. The host ms of a section is then the time to launch its
graph; under the profiler each kernel of the graph is linked, by
correlation id, to the graph's launch, inside the section's range. A
graph is replayed inside its innermost span only: a section opened inside
another section would be replayed without its parent's span (no section of
the detector is).

**Counters.** ``count(name, frames)`` adds one event to ``Trace.counts``
under ``name``, in the same form as a span's counts, and does nothing with
tracing off. Each call of that detect counts one of ``graph_replay`` (the
call's graphs were replayed), ``graph_capture`` (the call was captured as
graphs and then replayed: the second call of an input signature) and
``graph_eager`` (it ran eagerly: on the CPU, a mesh, a model in training
mode, under autocast or a trace, the first call of a signature, or a
detector that already holds graphs of as many signatures as it keeps).
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
    ``calls`` and the ``frames`` its spans gave (per counter of ``count``
    its events and their frames)."""

    spans: list
    counts: dict


_OFF = contextlib.nullcontext()   # the span of tracing off, shared
_requests = itertools.count(1)   # next() on it is atomic under the GIL
_local = threading.local()
_active = None   # the open collect's list of _Thread records, or None: off
_cut = None   # the running cut_at_spans's _Cut, or None
_on = False   # _active or _cut: the one flag a span checks


class _Thread:
    """One thread's records in one ``collect``, and its stack of open
    spans."""

    def __init__(self, run: list):
        self.run, self.records, self.stack = run, [], []
        self.counts = []   # (name, frames) of each count()
        run.append(self)


def _thread_of(run: list) -> _Thread:
    thread = getattr(_local, "thread", None)
    if thread is None or thread.run is not run:
        thread = _local.thread = _Thread(run)
    return thread


class _Cut:
    """The capturing thread's ``cut_at_spans``: its ``boundary`` and the
    stack of the sections open inside it."""

    def __init__(self, boundary):
        self.boundary = boundary
        self.thread = threading.get_ident()
        self.stack = [(None, None)]


class _Span:
    __slots__ = ("thread", "cut", "name", "frames", "index", "range")

    def __init__(self, thread: _Thread | None, cut: _Cut | None, name: str,
                 frames):
        self.thread, self.cut, self.name, self.frames = (thread, cut, name,
                                                         frames)
        self.range = None

    def __enter__(self):
        if self.cut is not None:
            self.cut.stack.append((self.name, self.frames))
            self.cut.boundary(self.name, self.frames)
        t = self.thread
        if t is None:
            return self
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
        if t is not None:
            t.records[self.index][4] = time.perf_counter_ns()
            if self.range is not None:
                self.range.__exit__(*exc)
            t.stack.pop()
        if self.cut is not None:
            self.cut.stack.pop()
            if exc[0] is None:
                self.cut.boundary(*self.cut.stack[-1])
        return False


def span(name: str, frames: int | None = None):
    """A context manager around one section of a call: ``name`` is the
    section, ``frames`` the frames it works on where it counts them."""
    if not _on or torch.compiler.is_compiling():
        return _OFF
    run, cut = _active, _cut
    if cut is not None and cut.thread != threading.get_ident():
        cut = None
    if run is None and cut is None:
        return _OFF
    return _Span(None if run is None else _thread_of(run), cut, name, frames)


def count(name: str, frames: int | None = None) -> None:
    """One event of the counter ``name`` (with the ``frames`` it concerns)
    into the open ``collect``'s ``Trace.counts``; nothing with tracing
    off."""
    run = _active
    if run is None or torch.compiler.is_compiling():
        return
    _thread_of(run).counts.append((name, frames))


@contextlib.contextmanager
def cut_at_spans(boundary):
    """Inside, on this thread, each span's entry and exit calls
    ``boundary(name, frames)`` with the section that starts there: on entry
    the span's own name and frames, on exit those of the span it was opened
    in (``None, None`` for none opened inside ``cut_at_spans``). A CUDA
    graph's capture ends one graph and begins the next there, so that each
    graph holds one section. Spans of other threads are not cut. Calls do
    not nest."""
    global _cut, _on
    if _cut is not None:
        raise RuntimeError("tracing.cut_at_spans() is already on; calls do "
                           "not nest")
    _cut = _Cut(boundary)
    _on = True
    try:
        yield
    finally:
        _cut = None
        _on = _active is not None


@contextlib.contextmanager
def collect():
    """Tracing on inside; the ``Trace`` it yields is filled on exit, when
    tracing goes off again. Calls do not nest."""
    global _active, _on
    if _active is not None:
        raise RuntimeError("tracing.collect() is already on; calls do not "
                           "nest")
    run, out = [], Trace([], {})
    _active = run
    _on = True
    try:
        yield out
    finally:
        _active = None
        _on = _cut is not None
        for thread in run:
            base = len(out.spans)
            for name, request, parent, start, end, frames in thread.records:
                out.spans.append(Span(name, request,
                                      parent + base if parent >= 0 else -1,
                                      start, end, frames))
                _add(out.counts, name, frames)
            for name, frames in thread.counts:
                _add(out.counts, name, frames)


def _add(counts: dict, name: str, frames) -> None:
    entry = counts.setdefault(name, {"calls": 0, "frames": 0})
    entry["calls"] += 1
    entry["frames"] += frames or 0
