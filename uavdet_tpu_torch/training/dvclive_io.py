"""DVCLive-compatible metric emission.

The reference logs through DVCLiveLogger (train.py:41-43) producing:
  * ``dvclive/metrics.json``               — final scalars
  * ``dvclive/plots/metrics/<split>/<name>.tsv`` — step series
consumed by the dvc.yaml plots/metrics contract (reference dvc.yaml:31-73).
This writer reproduces those files without the dvclive dependency.

The port's own copy of ``uavdet_tpu/training/dvclive_io.py`` (that
package imports JAX); ``tests/test_torch_train_optim.py`` holds the two
equal. Under ``torch.distributed`` rank 0 alone writes, as the JAX trainer
flushes on process 0 alone (one writer on a shared filesystem).
"""

import json
import os
from collections import defaultdict
from typing import Dict

import torch.distributed as dist


class MetricsWriter:
    def __init__(self, out_dir: str = "dvclive"):
        self.out_dir = out_dir
        self._series = defaultdict(list)  # (split, name) -> [(step, value)]
        self._latest: Dict[str, float] = {}
        self._step = 0

    def log(self, name: str, value: float, step: int | None = None):
        """name like 'train/loss' or 'val/bbox_loss'."""
        step = self._step if step is None else step
        split, metric = name.split("/", 1)
        self._series[(split, metric)].append((step, float(value)))
        self._latest[name] = float(value)

    def next_step(self):
        self._latest["step"] = self._step
        self._step += 1

    def set_epoch(self, epoch: int):
        """Record the current epoch — emitted as the top-level ``epoch``
        key (reference dvclive/metrics.json:7)."""
        self._latest["epoch"] = int(epoch)

    def flush(self):
        if dist.is_initialized() and dist.get_rank() != 0:
            return
        for (split, metric), rows in self._series.items():
            d = os.path.join(self.out_dir, "plots", "metrics", split)
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, f"{metric}.tsv"), "w") as f:
                f.write(f"step\t{metric}\n")
                for step, v in rows:
                    f.write(f"{step}\t{v}\n")

        os.makedirs(self.out_dir, exist_ok=True)
        flat = {}
        for name, v in self._latest.items():
            if name in ("step", "epoch"):
                flat[name] = v
                continue
            split, metric = name.split("/", 1)
            flat.setdefault(split, {})[metric] = v
        with open(os.path.join(self.out_dir, "metrics.json"), "w") as f:
            json.dump(flat, f, indent=2)
