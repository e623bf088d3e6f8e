"""Timing on the card: CUDA events, and the card's name and power limit that
every kept number stands beside."""

import statistics
import subprocess
import time

import torch


def card_line() -> str:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int) -> float:
    """Median device time of one call of ``fn`` in ms, by CUDA events, after
    ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def back_to_back_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of one call of ``fn`` in ms among ``iters`` launched
    back to back between two CUDA events: where a call's device work
    outlasts the host's time to launch it, the work alone. (One call between
    two events also counts the host's time to launch it, which is most of
    the reading for a kernel of some 30 us.)"""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_total(run, iters: int, warmup: int, device="cuda") -> float:
    """Seconds taken by ``iters`` calls of ``run`` issued back to back, after
    ``warmup`` calls: the throughput of pipelined calls, where the host's gaps
    between calls count because the card idles in them. On a CUDA device the
    window lies between two CUDA events recorded after a synchronize; on any
    other device it is the host clock's."""
    for _ in range(warmup):
        run()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        return time.perf_counter() - t0
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3
