#!/usr/bin/env python3
"""DyYOLO's device time by section of the network, beside each section's floor.

Port of ``scripts/section_probe.py``. Full-width DyYOLO (the model of
params.yaml, ``models.registry.DYYOLO``) with seeded random weights
(``utils/seeding.py``), bf16, on uint8 frames at the detector's size. The
sections are the JAX table's, cut at the same tokens
(``roofline_table.token_sections``):

  stem   tokens 0-1: kernels A and B and their weight mixing
         (``ops/stem.py:StemFastPath.stem``)
  early  through the 256-channel stride-2 conv
  mid    through the 512-channel stride-2 conv
  deep   the rest of the tail and the heads
  post   ``Detector.post``: the global top-k and decode, the threshold and
         the NMS (kernel C)

One sectioned call runs the detector's own modules in order: the stem, the
tail as ``parallel.pipeline.PipelineStage``s cut at the section tokens, then
``inference.Detector.post``. Where the JAX script timed fresh-weight prefix
programs and took differences, this one measures in context in one program:
the call records a CUDA event after each section, ``--iters`` calls are
issued back to back with no host sync inside the window, the events are
read after one synchronize, and each section's reading is its median. The
whole call, eager as the sectioned one (``inference.Detector``; the
served ``make_detector`` detect replays it as CUDA graphs on the card,
without the host's gaps between launches), is timed back to back the same
way (``utils.timing.time_total``); the sections' sum should read what it
reads.

Before the timing one sectioned call is held against ``Detector.heads``
and the served detect (``make_detector``'s, at its third call: replayed as
CUDA graphs on the card) on the same frames: the heads and the Detections
must be bitwise equal. The kernels' launches during the sectioned calls are
counted (``kernels.launch_counts``). Each section's floor comes from
``roofline_table.section_floors`` (post has none).

On the card unless ``--device cpu`` is given; there the kernels' plain
versions run in float32 and the sections are read by the host's clock.

Usage: python3 -m uavdet_tpu_torch.scripts.section_probe [--batch 16]
       [--input 640] [--iters 20] [--warmup 3] [--seed 0] [--device cpu]
"""

import argparse
import statistics
import time

import numpy as np
import torch

from .roofline_table import SECTIONS, section_floors, token_sections


def no_mark(name: str) -> None:
    pass


def sectioned_dyyolo(det):
    """-> (names, run): ``run(frames, mark)`` is ``det``'s detect (an
    ``inference.Detector`` of a DyYOLO with the stem kernels) cut into
    ``names``, calling ``mark(name)`` after each; it returns (heads,
    Detections)."""
    from ..ops.stem import STEM_TOKENS
    from ..parallel.pipeline import PipelineStage
    model = det.model
    labels = token_sections(model.tokens)
    n_stem = len(STEM_TOKENS)
    ranges, start = [], 0
    for i in range(1, len(labels) + 1):
        if i == len(labels) or labels[i] != labels[start]:
            ranges.append((labels[start], start, i))
            start = i
    if det.stem is None or [r[0] for r in ranges] != list(SECTIONS) \
            or ranges[0][1:] != (0, n_stem):
        raise ValueError("section_probe takes a DyYOLO that starts with the "
                         f"stem tokens {STEM_TOKENS} and has each of the "
                         f"sections {SECTIONS}; its tokens give {ranges}")
    stages = [(name, PipelineStage(model, s, e, e == len(labels)))
              for name, s, e in ranges[1:]]

    def run(frames, mark=no_mark):
        x = det.stem.stem(det.prepare(frames))
        mark("stem")
        carry = (x.to(model.dtype).permute(0, 3, 1, 2), (), ())
        for name, stage in stages:
            carry = stage(*carry)
            mark(name)
        dets = det.post(carry)
        mark("post")
        return carry, dets

    return [*SECTIONS, "post"], run


def device_of(name: str) -> torch.device:
    """The probes' device: the card unless named; raises when it is a CUDA
    device that is not there."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is visible (--device cpu runs the "
                         "kernels' plain versions)")
    return device


def uint8_frames(seed: int, shape, device) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, size=shape, dtype=np.uint8)).to(device)


def _columns(rows, names) -> dict:
    """[[ms per section] per call] -> {name: [ms per call]}."""
    return {name: [r[k] for r in rows] for k, name in enumerate(names)}


def host_readings(run, frames, names, calls: int, device) -> dict:
    """{name: [ms]}: the host's time to issue each section, in ``calls``
    calls each issued onto an idle device."""
    rows = []
    for _ in range(calls):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        stamps = [time.perf_counter()]
        run(frames, lambda name: stamps.append(time.perf_counter()))
        rows.append([(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])])
    return _columns(rows, names)


def _sleep_cycles(ms: float) -> int:
    """Cycles of ``torch.cuda._sleep`` that keep the card busy ``ms``."""
    probe = 10_000_000
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(probe)
    end.record()
    end.synchronize()
    return int(probe * ms / start.elapsed_time(end))


def device_readings(run, frames, names, iters: int, lead_ms: float) -> dict:
    """{name: [ms]} on the card: ``iters`` calls, each issued while the
    card runs a sleep kernel of ``lead_ms`` (longer than the host takes to
    issue a call), so that the events at its cuts bracket each section's
    device work alone, with no wait for the host inside the call."""
    cycles = _sleep_cycles(lead_ms)
    held = []
    for _ in range(iters):
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(len(names) + 1)]
        torch.cuda._sleep(cycles)
        marks[0].record()
        it = iter(marks[1:])
        run(frames, lambda name: next(it).record())
        held.append(marks)
    held[-1][-1].synchronize()
    return _columns([[a.elapsed_time(b) for a, b in zip(m, m[1:])]
                     for m in held], names)


def back_to_back(run, frames, names, iters: int, device, then):
    """``iters`` sectioned calls, each followed by ``then()``, issued back
    to back with no host sync inside the window. On the card each interval
    lies between the CUDA events recorded at the cuts and after ``then``
    (a call's first section starts at the event that ended the ``then``
    before it), read after one synchronize; elsewhere the host's clock.
    Where the host issues a call more slowly than the card runs it, the
    card's waits for the host fall in these intervals. -> ({name: [ms]},
    [ms of each ``then``])."""
    n = len(names) + 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(iters * n + 1)]
        it = iter(events)

        def mark(name=None):
            next(it).record()
    else:
        stamps = []

        def mark(name=None):
            stamps.append(time.perf_counter())
    mark()
    for _ in range(iters):
        run(frames, mark)
        then()
        mark()
    if device.type == "cuda":
        events[-1].synchronize()
        ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    else:
        ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    rows = [ms[i * n:(i + 1) * n] for i in range(iters)]
    return _columns(rows, names), [r[-1] for r in rows]


def _same_heads(a, b) -> bool:
    return len(a) == len(b) and all(
        torch.equal(x.bbox, y.bbox) and torch.equal(x.obj, y.obj)
        for x, y in zip(a, b))


def _same_detections(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


@torch.inference_mode()
def measure(det, detect, served, names, run, frames, floors: dict,
            iters: int, warmup: int) -> dict:
    """The probe. One sectioned call against ``det.heads`` and the third
    call of ``served`` (eager, captured, replayed) on the same frames
    (bitwise); the host's issue time per section over
    the warm-up calls and, on the card, each section's device time alone
    (``device_readings``), the launches of these sectioned calls counted;
    then ``detect`` timed back to back (``utils.timing.time_total``), the
    sectioned calls back to back in turns with ``detect`` calls
    (``back_to_back``), and ``detect`` again. -> the report
    ``print_report`` prints: per section the medians of the three
    readings, the floor and floor / ms; the sum of the sections' ``ms``
    beside the median of the ``detect`` calls between them."""
    from .. import kernels
    from ..utils.timing import time_total
    device = frames.device
    heads, dets = run(frames)
    for _ in range(3):
        replayed = served(frames)
    report = {
        "heads_equal": _same_heads(heads, det.heads(det.prepare(frames))),
        "detections_equal": _same_detections(dets, replayed)}
    calls = max(warmup, 1)
    kernels.reset_launch_counts()
    readings = {"host_ms": host_readings(run, frames, names, calls, device),
                "device_ms": None}
    if device.type == "cuda":
        lead = 2.0 * max(map(sum, zip(*readings["host_ms"].values()))) + 1.0
        readings["device_ms"] = device_readings(run, frames, names, iters,
                                                lead)
        calls += iters
    report.update(calls=calls, launches=kernels.launch_counts())

    def detect_window():
        return time_total(lambda: detect(frames), iters, warmup,
                          device) * 1e3 / iters

    windows = [detect_window()]
    readings["ms"], between = back_to_back(run, frames, names, iters, device,
                                           lambda: detect(frames))
    windows.append(detect_window())
    sections = {}
    for name in names:
        sec = {k: None if v is None else statistics.median(v[name])
               for k, v in readings.items()}
        floor = floors.get(name)
        sec.update(floor_ms=floor,
                   floor_share=None if floor is None else floor / sec["ms"])
        sections[name] = sec
    total = sum(s["ms"] for s in sections.values())
    detect_ms = statistics.median(between)
    report.update(sections=sections, sum_ms=total, detect_ms=detect_ms,
                  detect_windows_ms=windows, sum_over_detect=total / detect_ms,
                  iters=iters, warmup=warmup)
    for key in ("device_ms", "host_ms"):
        report[key.replace("_ms", "_sum_ms")] = (
            None if readings[key] is None
            else sum(s[key] for s in sections.values()))
    return report


def device_line(device) -> str:
    """What a probe ran on: the card's name and power limit, or the device
    whose host clock timed the kernels' plain versions."""
    if device.type == "cuda":
        from ..utils.timing import card_line
        return f"card: {card_line()}"
    return f"device: {device} (the kernels' plain versions, host clock)"


def print_report(title: str, report: dict, device) -> None:
    print(f"{title}; {device_line(device)}")
    print(f"medians of {report['iters']} calls: ms back to back (in turns "
          "with detect); device ms with the host ahead of the card; host ms "
          f"to issue ({max(report['warmup'], 1)} calls); floor ms "
          "(roofline_table)")
    print(f"{'section':10s} {'ms':>9s} {'device ms':>9s} {'host ms':>9s} "
          f"{'floor ms':>9s} {'floor/ms':>9s} {'share':>7s}")

    def cell(v):
        return "-" if v is None else f"{v:.4g}"

    for name, s in report["sections"].items():
        print(f"{name:10s} {s['ms']:9.3f} {cell(s['device_ms']):>9s} "
              f"{s['host_ms']:9.3f} {cell(s['floor_ms']):>9s} "
              f"{cell(s['floor_share']):>9s} "
              f"{s['ms'] / report['sum_ms']:7.3f}")
    print(f"{'sum':10s} {report['sum_ms']:9.3f} "
          f"{cell(report['device_sum_ms']):>9s} "
          f"{report['host_sum_ms']:9.3f}")
    print(f"detect back to back: {report['detect_ms']:.3f} ms per call in "
          "turns with the sectioned calls; sum of sections / detect "
          f"{report['sum_over_detect']:.4f}; detect alone (time_total) "
          "before and after: "
          f"{', '.join(f'{w:.3f}' for w in report['detect_windows_ms'])} ms")
    print(f"heads bitwise equal to Detector.heads: {report['heads_equal']}; "
          f"Detections bitwise equal to detect's: "
          f"{report['detections_equal']}")
    print(f"launches in {report['calls']} sectioned calls: "
          f"{report['launches']}", flush=True)


def parse_args(argv, batch: int, size: int, iters: int):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=batch)
    ap.add_argument("--input", type=int, default=size)
    ap.add_argument("--iters", type=int, default=iters)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and frames")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; cpu runs the "
                    "kernels' plain versions in float32)")
    return ap.parse_args(argv)


def main(argv=None, model=None) -> dict:
    """Prints the section table; -> the report. ``model``: a DyYOLO to
    probe in place of a freshly seeded one (on ``--device``)."""
    from ..inference import Detector, make_detector
    from ..models.registry import DYYOLO, serving_dtype
    from ..utils.seeding import seeded_model
    args = parse_args(argv, 16, 640, 20)
    device = device_of(args.device)
    dtype = serving_dtype(device)
    if model is None:
        model = seeded_model("DyYOLO", DYYOLO, args.seed, device)
    kw = dict(compute_dtype=dtype)
    det = Detector(model, DYYOLO, args.input, **kw)
    detect = torch.inference_mode()(det)   # the whole call, eager
    served = make_detector(model, DYYOLO, args.input, **kw)
    names, run = sectioned_dyyolo(det)
    frames = uint8_frames(args.seed, (args.batch, args.input, args.input, 3),
                          device)
    floors = section_floors(args.batch, args.input, model.tokens)
    report = measure(det, detect, served, names, run, frames, floors,
                     args.iters, args.warmup)
    report.update(model="DyYOLO", batch=args.batch, input=args.input)
    print_report(f"DyYOLO batch {args.batch} at {args.input} px, {dtype}",
                 report, device)
    return report


if __name__ == "__main__":
    main()
