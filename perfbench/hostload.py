"""How fast the host ran around a window: the milliseconds that a fixed
piece of pure-Python work takes (the median of five), read before and
after the window. A host-held cell's rate follows the host's speed, which
other work on a shared machine lowers; the reading is printed beside every
run so that a spread between runs can be traced to it."""

import statistics
import time

WORK = 200_000


def yardstick_ms() -> float:
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        total = 0
        for i in range(WORK):
            total += i & 7
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)
