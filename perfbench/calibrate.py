"""The readings that the limits of ``correct`` are set from, at a cell's own
sizes:

  python3 -m perfbench.calibrate --workload <cell> --seeds 1,2,... \\
      [--control-seeds 7,8,9] [--faults nms_off,nms_loose \\
      --fault-seeds 4,5,6] [--seconds 2]

For each of ``--seeds`` the program's numbers (set-up, a short window at
the cell's load, the check), for each of ``--control-seeds`` the control's
(the reference in float8 in the program's place) and, for each fault of
``--faults`` (``faults.FAULTS``) and each of ``--fault-seeds``, those of
the program with that fault planted. One JSON line per reading on stdout,
then the lower reading (the largest over the program's seeds) and the
smallest of the control's and of each fault's readings of each number, and
whether each of those runs would have been judged correct by the cell's
limits. All in one process: the kernels build once.
"""

import argparse
import json
import sys
import time

import torch

from . import compare
from .drive import cell_class, entry
from .faults import FAULTS
from .run import cell_entries, load_benchmark


def _list(text: str) -> list:
    return [s for s in text.split(",") if s]


def reading(kind: str, seed: int, parts: list, lims: dict, t0: float):
    numbers = {k: max(p[k] for p in parts) for k in parts[0]}
    line = {"kind": kind, "seed": seed, "numbers": numbers,
            "correct": all(numbers[k] <= v for k, v in lims.items()),
            "seconds": time.perf_counter() - t0}
    print(json.dumps(line), flush=True)
    return line


def program_reading(cls, config, mix, seed, device, seconds, kind, lims):
    t0 = time.perf_counter()
    cell = cls(config, mix, seed, device)
    cell.setup()
    cell.window(seconds)
    cell.free()
    return reading(kind, seed, cell.check(), lims, t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _, _, config, mix = cell_entries(load_benchmark(), args.workload)
    cls = cell_class(mix["kind"])
    lims = compare.limits(args.workload)
    lines = []
    for seed in map(int, _list(args.seeds)):
        lines.append(program_reading(cls, config, mix, seed, args.device,
                                     args.seconds, "program", lims))
    for seed in map(int, _list(args.control_seeds)):
        t0 = time.perf_counter()
        cell = cls(config, mix, seed, args.device)
        cell.inputs()
        lines.append(reading("control", seed, cell.control(), lims, t0))
        del cell
    mod = entry(config["entry"])
    sound = mod.build
    for name in _list(args.faults):
        mod.build = FAULTS[name](sound)
        try:
            for seed in map(int, _list(args.fault_seeds)):
                lines.append(program_reading(cls, config, mix, seed,
                                             args.device, args.seconds,
                                             name, lims))
        finally:
            mod.build = sound
    summary = {}
    for kind in dict.fromkeys(ln["kind"] for ln in lines):
        rows = [ln for ln in lines if ln["kind"] == kind]
        pick = max if kind == "program" else min
        summary[kind] = {k: pick(r["numbers"][k] for r in rows)
                         for k in rows[0]["numbers"]}
        summary[kind]["correct_runs"] = sum(r["correct"] for r in rows)
        summary[kind]["runs"] = len(rows)
    print(json.dumps({"workload": args.workload, "limits": lims,
                      "summary": summary,
                      "card": torch.cuda.get_device_name()
                      if torch.cuda.is_available() else "cpu"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
