"""The program's own spans (``uavdet_tpu_torch.tracing``), read in the
traced run: host and device milliseconds a call of each section of the
detector, and the device's idle gaps named by the section the host was in.

``of(ctx)`` runs once per run context and keeps its result there. It builds
a second object of the cell's kind from the context's configuration and
traffic mix, a seed of this file and the run's device (its answers are not
judged: the slice times shapes), sets it up, and then

- the host slice: ``issue_calls`` pairs of calls into the program's entry,
  each after a synchronize and with no profiler, the first of a pair with
  tracing off and the second inside ``tracing.collect()``: the host ms a
  call of each span, its children included (the median over the calls of
  the sum of its spans in the call), and the cost of tracing on;
- on a card, the profiled slice: ``profile_calls`` steady calls under
  ``torch.profiler`` (CPU and CUDA activity) with tracing on, so each span
  is also the profiler range ``uavdet.<name>``. The device's copies of those
  ranges are left out of the device's intervals; every other interval goes
  to the innermost range that holds the host call that launched it, found
  by correlation id (the runtime call, else the operator it is linked to).
  A span's device ms a call is the union of its intervals over the calls:
  a parent's counts only what no child holds (``detect``'s own time).

and frees the object. ``host_ms`` and ``device_ms`` are what the readers
(``metrics/<span>_{host,device}_ms.<cell>.py``) read; None where the
program has no tracing module (the metric is then left out), where the
span did not run, or, for device ms, where there is no card. The slice
prints on stderr its tables, the host ms of the calls with tracing off and
on, beside ``host_issue_ms`` (the run's own object, tracing off), and the
ten longest idle gaps, each named by the innermost span and host
operator at its middle and by the device operation that ended it.

Beside ``program.py`` and ``entries/``, this is the one module of the
benchmark that imports the program: its ``tracing`` module. A later metric
of a section needs the section marked in the program with
``tracing.span("<span>")`` and a reader ``metrics/<metric>.py`` that
returns ``host_ms(ctx, "<span>")`` or ``device_ms(ctx, "<span>")``.
"""

import bisect
import statistics
import sys
import time
from typing import NamedTuple

import torch

from . import trace
from .drive import cell_class, sync

SEED = 1905190519
PREFIX = "uavdet."
KEY = "program_spans"


class Event(NamedTuple):
    """One event of a profile: a host range (operator, runtime call or
    span) or a device interval, with its correlation ids."""

    name: str
    start_us: float
    end_us: float
    correlation: int = 0
    linked: int = 0


def note(msg: str) -> None:
    print(f"# spans: {msg}", file=sys.stderr, flush=True)


def of(ctx: dict):
    """The spans' readings of this run (see the module), measured once."""
    if KEY not in ctx:
        ctx[KEY] = measure(ctx)
    return ctx[KEY]


def host_ms(ctx: dict, name: str):
    s = of(ctx)
    return None if s is None else s["host_ms"].get(name)


def device_ms(ctx: dict, name: str):
    s = of(ctx)
    return None if s is None or s["device_ms"] is None \
        else s["device_ms"].get(name)


def host_per_call(traces) -> tuple:
    """One ``tracing.Trace`` a call -> ({name: median over the calls of the
    host ms of its spans in the call, children included}, {name: the same,
    less the time its direct children took})."""
    whole, own = {}, {}
    for t in traces:
        w, o = {}, {}
        for s in t.spans:
            ms = (s.end_ns - s.start_ns) * 1e-6
            w[s.name] = w.get(s.name, 0.0) + ms
            o[s.name] = o.get(s.name, 0.0) + ms
            if s.parent >= 0:
                parent = t.spans[s.parent].name
                o[parent] = o.get(parent, 0.0) - ms
        for name in w:
            whole.setdefault(name, []).append(w[name])
            own.setdefault(name, []).append(o[name])
    return ({k: statistics.median(v) for k, v in whole.items()},
            {k: statistics.median(v) for k, v in own.items()})


class Spans:
    """The host's ``uavdet.*`` ranges of a profile, for finding the
    innermost one that holds an instant."""

    def __init__(self, host):
        self.ranges = sorted((e for e in host if e.name.startswith(PREFIX)),
                             key=lambda e: e.start_us)
        self.starts = [e.start_us for e in self.ranges]

    def at(self, t: float):
        """The innermost range holding ``t`` (ranges of one thread nest, so
        the latest started that has not ended), or None."""
        for i in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            if self.ranges[i].end_us >= t:
                return self.ranges[i]
        return None


def attribute(host, device) -> dict:
    """Each device interval, the device's copies of the spans left out ->
    the innermost span holding the start of the host call that launched it:
    the runtime call (``cu*``) of its correlation id, else the host
    operator it is linked to. -> {span name without the prefix, or None for
    a launch outside every span: [trace.Interval]}."""
    spans = Spans(host)
    runtime = {e.correlation: e for e in host
               if e.correlation and e.name.startswith("cu")}
    ops = {e.correlation: e for e in host
           if e.correlation and not e.name.startswith("cu")}
    out = {}
    for d in device:
        if d.name.startswith(PREFIX):
            continue
        launch = runtime.get(d.correlation) or ops.get(d.linked)
        inner = spans.at(launch.start_us) if launch is not None else None
        name = inner.name[len(PREFIX):] if inner is not None else None
        out.setdefault(name, []).append(
            trace.Interval(d.name, d.start_us, d.end_us))
    return out


def idle_by_span(device, host) -> dict:
    """The device's idle gaps -> {the innermost span at each gap's middle
    (without the prefix; None outside every span): their total in us}."""
    spans, out = Spans(host), {}
    for start, end in trace.gaps(device):
        inner = spans.at((start + end) / 2)
        name = inner.name[len(PREFIX):] if inner is not None else None
        out[name] = out.get(name, 0.0) + end - start
    return out


def name_gaps(device, host, n: int = 10) -> list:
    """The ``n`` longest idle gaps of ``device``, each named by the
    innermost span and host operation at its middle ("host" outside every
    span, "python" between operations) and by the device operation that
    ended it: [[name, s], ...]."""
    spans = Spans(host)
    ops = [e for e in host if not e.name.startswith(PREFIX)]
    starts = sorted(device, key=lambda iv: iv.start_us)
    out = []
    longest = sorted(trace.gaps(device), key=lambda g: g[0] - g[1])[:n]
    for start, end in longest:
        mid = (start + end) / 2
        inner = spans.at(mid)
        op = min((e for e in ops if e.start_us <= mid <= e.end_us),
                 key=lambda e: e.end_us - e.start_us, default=None)
        after = next((iv.name for iv in starts if iv.start_us >= end), "end")
        name = (f"{inner.name if inner else 'host'}/"
                f"{op.name if op else 'python'} -> {after[:60]}")
        out.append([name[:160], (end - start) * 1e-6])
    return out


def profile_events(prof) -> tuple:
    """A finished ``torch.profiler.profile`` -> (host events, device
    events), each with its correlation ids, on the profiler's clock."""
    from torch.autograd import DeviceType
    host, device = [], []
    for e in prof.profiler.kineto_results.events():
        if e.end_ns() <= e.start_ns():
            continue
        ev = Event(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3,
                   e.correlation_id(), e.linked_correlation_id())
        (device if e.device_type() == DeviceType.CUDA else host).append(ev)
    return host, device


def issue_ms(cell, device) -> float:
    """Host ms of one call into the program's entry, the device drained
    before it."""
    sync(device)
    t0 = time.perf_counter()
    cell.issue()
    return (time.perf_counter() - t0) * 1e3


def profiled(cell, calls: int, tracing) -> dict:
    """The profiled slice (see the module) -> device ms a call by span and
    the busy ms a call."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with tracing.collect(), profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as p:
        for _ in range(calls):
            cell.run_one()
        torch.cuda.synchronize()
    host, device = profile_events(p)
    device = [d for d in device if not d.name.startswith(PREFIX)]
    by_span = attribute(host, device)
    per_call = {k: trace.union_us(v) / calls / 1e3
                for k, v in by_span.items()}
    idle = {k: v / calls / 1e3 for k, v in idle_by_span(device, host).items()}
    out = {"device_ms": {k: v for k, v in per_call.items() if k},
           "busy_ms": trace.union_us(device) / calls / 1e3}
    note(f"device ms a call (own): {out['device_ms']}, outside every span "
         f"{per_call.get(None, 0.0)}, busy {out['busy_ms']}; idle ms a call "
         f"by span: {idle}")
    note(f"idle gaps of the profiled slice ({calls} calls), longest: "
         f"{name_gaps(device, host)}")
    return out


def measure(ctx: dict):
    """The host slice and, on a card, the profiled slice, over a second
    object of the cell's kind; None where the program has no spans."""
    try:
        from uavdet_tpu_torch import tracing
    except ImportError:
        return None
    t0 = time.perf_counter()
    mix = ctx["traffic"]
    device = torch.device("cpu" if ctx["device_kind"] == "cpu" else "cuda")
    cell = cell_class(mix["kind"])(ctx["config"], mix, SEED, device)
    cell.setup()
    off, on, traces = [], [], []
    for _ in range(mix["issue_calls"]):
        off.append(issue_ms(cell, device))
        with tracing.collect() as t:
            on.append(issue_ms(cell, device))
        traces.append(t)
    whole, own = host_per_call(traces)
    before = ctx.get("issue_ms")
    note(f"host ms a call (children included): {whole}; own: {own}; "
         f"counts of a call: {t.counts}")
    note(f"host ms of a call, median, calls off and on in turn: off "
         f"{statistics.median(off)}, on {statistics.median(on)}, on - off "
         f"{statistics.median(b - a for a, b in zip(off, on))} (detect span "
         f"{whole.get('detect')}); host_issue_ms (off, the run's own object) "
         f"{statistics.median(before) if before else None}")
    out = {"host_ms": whole, "device_ms": None}
    if device.type == "cuda":
        out.update(profiled(cell, mix["profile_calls"], tracing))
    cell.free()
    note(f"the slices took {time.perf_counter() - t0} s")
    return out
