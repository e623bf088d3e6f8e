"""The benchmark of ``uavdet_tpu_torch`` on the card.

  python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s>
                           --trace <0|1>

runs one cell of ``BENCHMARK.json`` from the root of a checkout: its
configuration (``configs/<config>.json``) and traffic mix
(``traffic/<mix>.json``) found by name, the mix's kind (``kinds/<kind>.py``)
and the configuration's program entry (``entries/<entry>.py``) by the names
they give, its weights and inputs made on the device from ``--seed``.
Set-up builds the program and warms up every shape the mix uses; the window
then drives the mix for ``--seconds``. Every metric is read by
``metrics/<name>.py``: with ``--trace 0`` the cell's end-to-end metrics,
from set-up and the window; with ``--trace 1`` its per-layer metrics, from
the window, a host-clock slice of calls into the program's entry and two
short profiled slices, with ``device.busy_s`` / ``window_s`` and a
``breakdown`` of the trace. Then the program's state is freed and the
plain reference (``reference/``) judges a sample of the window's answers
(``compare``, limits in ``limits/<cell>.json``).

The last line of stdout is one JSON object; the numbers compared, each with
its limit, are the last lines of stderr and the result's last key. Exit
codes other than 0 print no result: 2 without the cards the cell asks for,
3 without the program beside the benchmark, 4 when JAX or the JAX package
was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "uavdet_tpu")


def note(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_entries(bench: dict, name: str, root: Path = ROOT):
    """-> (the workload, its configuration entry, the configuration file's
    content, the traffic mix's content), found by name under ``root``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((root / conf["file"]).read_text())
    mix = json.loads((root / "perfbench" / "traffic"
                      / f"{cell['traffic']}.json").read_text())
    return cell, conf, config, mix


def metrics_of(bench: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that this cell reports."""
    return [m for m in bench[kind]
            if cell in m.get("workloads", [w["name"] for w in
                                           bench["workloads"]])]


def reader(name: str, root: Path = ROOT):
    """``metrics/<name>.py``'s ``read``."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit by nvidia-smi, or why not."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unreadable ({e})"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the measured path); cpu only for the "
                    "harness's own tests, at the sizes they set")
    return ap.parse_args(argv)


def read_metrics(bench, name: str, kind: str, ctx: dict) -> dict:
    """The cell's ``kind`` metrics, each by its reader; a reader that finds
    nothing leaves its metric out."""
    out = {}
    for m in metrics_of(bench, name, kind):
        value = reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def traced(cellobj, mix: dict, ctx: dict, device) -> tuple:
    """The traced run's slices after the window: ``ctx`` gains what the
    per-layer readers read. -> (device's busy_s, the slice's window_s,
    breakdown)."""
    import torch

    from . import trace
    from .drive import sync
    issue = []
    for _ in range(mix["issue_calls"]):
        sync(device)
        t0 = time.perf_counter()
        cellobj.issue()
        issue.append((time.perf_counter() - t0) * 1e3)
    sync(device)
    dev, slice_s = trace.device_slice(cellobj.run_one, mix["profile_calls"])

    def labelled():
        with torch.profiler.record_function("bench.call"):
            cellobj.run_one()

    dev2, host2 = trace.labelled_slice(labelled, mix["label_calls"])
    busy_s = trace.union_us(dev) * 1e-6
    ctx.update(issue_ms=issue, kernels=trace.by_name(dev), busy_s=busy_s,
               slice_s=slice_s, profile_calls=mix["profile_calls"])
    breakdown = {"device_ops": trace.top_ops(dev),
                 "idle_gaps": trace.label_gaps(dev2, host2)}
    return busy_s, slice_s, breakdown


def main(argv=None) -> int:
    args = parse_args(argv)
    bench = load_benchmark()
    cell, _, config, mix = cell_entries(bench, args.workload)
    import torch
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell["chips"]:
            note(f"the cell needs {cell['chips']} CUDA device(s); "
                 f"available: {torch.cuda.is_available()}, count "
                 f"{torch.cuda.device_count()}")
            return 2
        note(f"card: {card_line()}; torch {torch.__version__} cuda "
             f"{torch.version.cuda}")
    if importlib.util.find_spec("uavdet_tpu_torch") is None \
            or not (ROOT / "uavdet_tpu_torch").is_dir():
        note("the program (uavdet_tpu_torch) is not beside the benchmark")
        return 3
    from . import compare, hostload, program
    from .drive import cell_class
    cellobj = cell_class(mix["kind"])(config, mix, args.seed, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    cellobj.setup()
    setup_s = time.perf_counter() - T_START
    note(f"set-up {setup_s} s")
    host = {"yardstick_ms_before": hostload.yardstick_ms()}
    win = cellobj.window(args.seconds)
    host["yardstick_ms_after"] = hostload.yardstick_ms()
    note("window: " + json.dumps({k: v for k, v in win.items()
                                  if not isinstance(v, list)}))
    note(f"host around the window: {json.dumps(host)}")
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else str(device))
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": kind, "count": cell["chips"]}
    ctx = {"setup_s": setup_s, "window": win, "config": config,
           "traffic": mix, "device_kind": kind}
    result = {}
    if args.trace == 0:
        metrics = read_metrics(bench, args.workload, "end_to_end", ctx)
    else:
        busy_s, window_s, breakdown = traced(cellobj, mix, ctx, device)
        metrics = read_metrics(bench, args.workload, "per_layer", ctx)
        device_info.update(busy_s=busy_s, window_s=window_s)
        result["breakdown"] = breakdown
    device_info["memory_peak_bytes"] = (
        torch.cuda.max_memory_allocated(device) if device.type == "cuda"
        else 0)
    if device.type == "cuda":
        note("launches: " + json.dumps(program.launch_counts()))
    cellobj.free()
    t0 = time.perf_counter()
    parts = cellobj.check()
    lims = compare.limits(args.workload)
    numbers = {k: max(p[k] for p in parts) for k in lims}
    failed = sum(any(p[k] > lims[k] for k in lims) for p in parts)
    note(f"reference check of {len(parts)} answers in "
         f"{time.perf_counter() - t0} s")
    found = forbidden_modules()
    if found:
        note(f"loaded in this process: {found} (the port must not load JAX "
             "or the JAX package)")
        return 4
    checks = compare.judge(numbers, lims)
    line = {"correct": failed == 0, "attempted": win["attempted"],
            "failed": failed, "metrics": metrics, "device": device_info,
            **result, "host": host, "checks": checks}
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
