"""What the metrics' readers (``metrics/<name>.py``) share. Each reader gets
the run's context (``run.context``): ``setup_s``, the unprofiled window's
readings (``window``), the cell's configuration and traffic mix, and in the
traced run also the host-clock issue times, the profiled slice's device
time by kernel name, its busy and wall seconds and its number of calls. A
reader that finds nothing to read returns None, and the metric is left out
of the result."""

import json
import statistics
from pathlib import Path

from . import walks

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json")
                   .read_text())


def peaks(ctx: dict):
    """The data sheet's peaks of the run's card, or None for a card that
    the table does not hold."""
    for key, row in PEAKS.items():
        if key in ctx["device_kind"]:
            return row
    return None


def setup(ctx: dict) -> float:
    """Seconds from the start of the run to the window."""
    return ctx["setup_s"]


def rate(ctx: dict) -> float:
    """Items (frames) of every call issued in the window / the window."""
    return ctx["window"]["rate"]


def latency_p95_ms(ctx: dict):
    """The 95th percentile (nearest rank) of every call's latency in the
    window, in milliseconds; None where the mix times no latency."""
    lat = sorted(ctx["window"].get("latencies_s", ()))
    if not lat:
        return None
    return lat[max(0, -(-95 * len(lat) // 100) - 1)] * 1e3


def issue_ms(ctx: dict):
    """Median host milliseconds of one call into the entry, the device
    drained before each."""
    return statistics.median(ctx["issue_ms"]) if ctx["issue_ms"] else None


def mfu(ctx: dict, passes: float):
    """Percent of the card's bf16 peak: ``passes`` x the forward's FLOPs per
    item (the configuration's walk) x the unprofiled window's items per
    second."""
    p = peaks(ctx)
    if p is None:
        return None
    size = ctx["traffic"]["size"]
    per_item = walks.flops(ctx["config"], 1, size)
    return 100.0 * passes * per_item * ctx["window"]["rate"] \
        / p["bf16_flops_per_s"]


def device_idle(ctx: dict):
    """Percent of a call's time in the unprofiled window with nothing on the
    device: 1 - (the device's busy time a call, the union of its intervals
    in the profiled slice over the slice's calls) / (the window's wall time
    a call). The profiler slows the host's issue of each launch, so the
    slice's own wall time would count the profiler's cost as idle."""
    win = ctx["window"]
    if ctx["busy_s"] <= 0 or not win["attempted"]:
        return None
    busy = ctx["busy_s"] / ctx["profile_calls"]
    return 100.0 * (1.0 - busy / (win["wall_s"] / win["attempted"]))


def roofline(ctx: dict, symbol: str, launches) -> float | None:
    """Percent of the floor: ``launches`` is one call's [(FLOPs, bytes)] of
    the kernel whose device name holds ``symbol``, in launch order; the
    floor of a launch is max(FLOPs / peak, bytes / bandwidth), and the
    device time per call is the kernel's total over the profiled calls."""
    p = peaks(ctx)
    rows = [v for name, v in ctx["kernels"].items() if symbol in name]
    if p is None or not rows:
        return None
    seconds = sum(t for t, _ in rows)
    calls = sum(n for _, n in rows) / len(launches)
    floor = sum(max(f / p["bf16_flops_per_s"], b / p["hbm_bytes_per_s"])
                for f, b in launches)
    return 100.0 * floor * calls / seconds
