"""Checkpoints with the best/last policy: ``uavdet_tpu/training/checkpoint.py``
with ``torch.save`` in place of Orbax.

``save`` writes ``last`` every time, and ``best-{epoch:02d}-{value:.4f}``
when the monitored value is the best so far (``mode`` min or max),
deleting the previous best; ``meta.json`` keeps the best value and name
across runs. Each checkpoint is a directory holding ``state.pt``: the
model's parameters and buffers (the BatchNorm running statistics among
them), the optimizer's and the scheduler's state, the step, and where the
accumulation stands (``mini_step`` and the gradients accumulated so far).
"""

import json
import os
import shutil
from typing import Optional

import torch

from ..utils.datatypes import TrainState

_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, ckpt_dir: str, monitor: str = "val_loss",
                 mode: str = "min"):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.best_value: Optional[float] = None
        self.best_path: Optional[str] = None
        self._meta_path = os.path.join(self.ckpt_dir, "meta.json")
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                meta = json.load(f)
            self.best_value = meta.get("best_value")
            self.best_path = meta.get("best_path")

    def _is_better(self, value: float) -> bool:
        if self.best_value is None:
            return True
        return (value < self.best_value if self.mode == "min"
                else value > self.best_value)

    def _save(self, state: TrainState, path: str) -> None:
        params = list(state.model.parameters())
        blob = {"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "scheduler": state.scheduler.state_dict(),
                "step": state.step, "mini_step": state.mini_step,
                "grads": [p.grad for p in params]}
        if os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(path)
        torch.save(blob, os.path.join(path, _FILE))

    def save(self, state: TrainState, epoch: int, metrics: dict) -> bool:
        """Save last and, if the monitored value is the best, best; -> True
        if it is a new best."""
        self._save(state, os.path.join(self.ckpt_dir, "last"))
        value = float(metrics[self.monitor])
        is_best = self._is_better(value)
        if is_best:
            name = f"best-{epoch:02d}-{value:.4f}"
            if self.best_path:
                old = os.path.join(self.ckpt_dir, self.best_path)
                if os.path.exists(old):
                    shutil.rmtree(old)
            self._save(state, os.path.join(self.ckpt_dir, name))
            self.best_value, self.best_path = value, name
        with open(self._meta_path, "w") as f:
            json.dump({"best_value": self.best_value,
                       "best_path": self.best_path, "epoch": epoch}, f)
        return is_best

    def restore(self, state: TrainState, name: str = "last") -> TrainState:
        """Load the named checkpoint into ``state`` (its model, optimizer
        and scheduler, in place, on the model's device) and return it."""
        device = next(state.model.parameters()).device
        blob = torch.load(os.path.join(self.ckpt_dir, name, _FILE),
                          map_location=device, weights_only=True)
        state.model.load_state_dict(blob["model"])
        state.optimizer.load_state_dict(blob["optimizer"])
        state.scheduler.load_state_dict(blob["scheduler"])
        for p, g in zip(state.model.parameters(), blob["grads"], strict=True):
            p.grad = g
        state.step, state.mini_step = blob["step"], blob["mini_step"]
        return state

    def has_checkpoint(self, name: str = "last") -> bool:
        return os.path.exists(os.path.join(self.ckpt_dir, name))
