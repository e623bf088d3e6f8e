"""Reading the device's work from ``torch.profiler``.

``device_slice`` runs a few steady calls under the profiler with CUDA
activity only (the host's own operators are not recorded, so the host runs
at nearly its unprofiled speed) and returns the device's intervals: every
kernel, copy and set. ``labelled_slice`` records host operators too, for
naming the device's idle gaps by what the host was doing in them.

Busy time is the union of the device's intervals, so work on two streams at
once counts once.
"""

import time
from typing import NamedTuple

import torch


class Interval(NamedTuple):
    name: str
    start_us: float
    end_us: float


def union_us(intervals) -> float:
    """The length of the union of ``intervals``."""
    total, end = 0.0, None
    for iv in sorted(intervals, key=lambda iv: iv.start_us):
        if end is None or iv.start_us > end:
            total += iv.end_us - iv.start_us
            end = iv.end_us
        elif iv.end_us > end:
            total += iv.end_us - end
            end = iv.end_us
    return total


def gaps(intervals) -> list:
    """The idle gaps between the union's pieces: (start_us, end_us)."""
    out, end = [], None
    for iv in sorted(intervals, key=lambda iv: iv.start_us):
        if end is not None and iv.start_us > end:
            out.append((end, iv.start_us))
        end = iv.end_us if end is None else max(end, iv.end_us)
    return out


def by_name(intervals) -> dict:
    """{name: (total seconds, count)}."""
    out = {}
    for iv in intervals:
        t, n = out.get(iv.name, (0.0, 0))
        out[iv.name] = (t + (iv.end_us - iv.start_us) * 1e-6, n + 1)
    return out


def top_ops(intervals, n: int = 10) -> list:
    """The ``n`` device operations that took most time: [[name, s], ...]."""
    rows = sorted(((t, name) for name, (t, _) in by_name(intervals).items()),
                  reverse=True)[:n]
    return [[name[:160], t] for t, name in rows]


def label_gaps(device, host, n: int = 10) -> list:
    """The ``n`` longest idle gaps of ``device``, each named by what the
    host was doing in its middle (the benchmark's span, then the innermost
    host operation, or "python" between operations) and by the device
    operation that ended it: [[name, s], ...]."""
    out = []
    starts = sorted(device, key=lambda iv: iv.start_us)
    for start, end in sorted(gaps(device), key=lambda g: g[0] - g[1])[:n]:
        mid = (start + end) / 2
        covering = [iv for iv in host if iv.start_us <= mid <= iv.end_us]
        spans = [iv for iv in covering if iv.name.startswith("bench.")]
        ops = [iv for iv in covering if not iv.name.startswith("bench.")]
        inner = min(ops, key=lambda iv: iv.end_us - iv.start_us, default=None)
        outer = max(spans, key=lambda iv: iv.end_us - iv.start_us,
                    default=None)
        after = next((iv.name for iv in starts if iv.start_us >= end), "end")
        name = (f"{outer.name if outer else 'host'}/"
                f"{inner.name if inner else 'python'} -> {after[:60]}")
        out.append([name[:160], (end - start) * 1e-6])
    return out


def _intervals(prof, device: bool) -> list:
    from torch.autograd import DeviceType
    want = DeviceType.CUDA if device else DeviceType.CPU
    return [Interval(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == want
            and e.time_range.end > e.time_range.start]


def device_slice(run, calls: int):
    """``calls`` calls of ``run`` between two synchronizes under the
    profiler (CUDA activity only). -> (device intervals, host seconds of the
    slice)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    return _intervals(prof, True), seconds


def labelled_slice(run, calls: int):
    """``calls`` calls of ``run`` under the profiler with host operators
    recorded. -> (device intervals, host intervals); the device's copies of
    the benchmark's own spans (``bench.*``) are left out of the first."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    device = [iv for iv in _intervals(prof, True)
              if not iv.name.startswith("bench.")]
    return device, _intervals(prof, False)
