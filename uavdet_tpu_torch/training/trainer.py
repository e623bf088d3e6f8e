"""Training orchestration: the single-device ``Trainer`` of
``uavdet_tpu/training/trainer.py`` in torch.

The same config surface (``config.train.trainer``): ``epochs``,
``grad_batches``, ``train_batches`` / ``val_batches`` (a float is a
fraction, an int a count), ``val_check_interval``,
``check_val_every_n_epoch``, ``precision``, ``grad_clip_val``,
``lr_scheduler_interval`` (in ``model.hparams``), ``eval_ap``,
``nan_guard`` / ``nan_guard_retries``, ``log_every_n_steps``, ``profiler``
(``torch.profiler``, a trace under ``logs/profile``), ``remat``; with the
best/last checkpoint policy and DVCLive-format metrics. ``fold_early`` is
a TPU layout rewrite that equals the unfolded step up to reassociation: it
is accepted and changes nothing. The multi-device keys (``devices``,
``fsdp_devices``, ``sp_devices``, ``ep_devices``, ``pp_devices`` above 1,
``multihost``) raise: the port trains on one device.

The model is built at construction with float32 parameters and seeded
weights (``train.seed``, ``utils.seeding.init_weights``); ``fit`` trains it
from its current weights, so a caller may load others into
``trainer.model`` first. ``train_pipe`` and ``val_pipe`` are iterables with
``len()`` whose items have ``image``, ``boxes`` and ``box_mask`` (numpy
arrays or tensors), such as ``data.DataPipeline``; the trainer moves them
to its device (a pipeline on the same device hands them over there).
"""

import contextlib
import math
import os
import time
from typing import Optional

import numpy as np
import torch

from ..ops.map import MeanAveragePrecision, add_detections
from ..utils.datatypes import BatchData
from ..utils.seeding import seeded_model
from .checkpoint import CheckpointManager
from .dvclive_io import MetricsWriter
from .optim import build_optimizer
from .steps import (REMAT_POLICIES, autocast, init_state, make_eval_step,
                    make_train_step)

_MULTI_DEVICE = ("devices", "fsdp_devices", "sp_devices", "ep_devices",
                 "pp_devices")
_METRICS = ("loss", "bbox_loss", "obj_loss")


def _limit(n_batches: int, limit) -> int:
    """Lightning's limit_*_batches: a float is a fraction, an int a count."""
    if limit is None:
        return n_batches
    if isinstance(limit, float):
        return max(1, int(n_batches * limit)) if limit <= 1.0 else int(limit)
    return min(n_batches, int(limit))


def _compute_dtype(precision) -> torch.dtype:
    if str(precision) in ("16", "bf16", "bfloat16", "16-mixed",
                          "bf16-mixed"):
        return torch.bfloat16
    return torch.float32


class Trainer:
    def __init__(self, config, train_pipe, val_pipe,
                 metrics: Optional[MetricsWriter] = None, device="cuda"):
        self.config = config
        self.train_pipe = train_pipe
        self.val_pipe = val_pipe
        tcfg = config.train.trainer
        for key in _MULTI_DEVICE:
            if int(tcfg.get(key, 1) or 1) > 1:
                raise ValueError(
                    f"train.trainer.{key}={tcfg.get(key)}: the torch port "
                    "trains on one device; multi-device training is ROADMAP "
                    "queue 1 item 8")
        if tcfg.get("multihost", False):
            raise ValueError("train.trainer.multihost: the torch port trains "
                             "on one device; multi-host training is ROADMAP "
                             "queue 1 item 8")
        self.epochs = int(tcfg.epochs)
        self.grad_batches = int(tcfg.get("grad_batches", 1) or 1)
        self.train_limit = tcfg.get("train_batches")
        self.val_limit = tcfg.get("val_batches")
        self.val_check_interval = tcfg.get("val_check_interval", 1.0)
        self.check_val_every_n_epoch = int(
            tcfg.get("check_val_every_n_epoch", 1) or 1)
        self.compute_dtype = _compute_dtype(tcfg.get("precision"))
        self.grad_clip_val = tcfg.get("grad_clip_val")
        self.profiler = tcfg.get("profiler")
        self.eval_ap = bool(tcfg.get("eval_ap", False))
        self.nan_guard = bool(tcfg.get("nan_guard", False))
        self.nan_guard_retries = int(tcfg.get("nan_guard_retries", 3))
        self.remat = tcfg.get("remat", False) or False
        if self.remat not in (False, *REMAT_POLICIES):
            raise ValueError(f"train.trainer.remat={self.remat!r} has no "
                             "counterpart in the torch port; it takes "
                             "false, true or 'dots_saveable'")
        # accepted and without effect (see the module docstring)
        self.fold_early = bool(tcfg.get("fold_early", False))
        # metrics are fetched from the device once per K steps
        self.log_every_n_steps = int(tcfg.get("log_every_n_steps", 50) or 1)
        self._n_metric_syncs = 0
        self.input_size = int(config.dataset.image_size[0])
        self.metrics = metrics or MetricsWriter()
        self.device = torch.device(device)

        hparams = config.model.hparams
        self.model = seeded_model(config.model.name, hparams,
                                  int(config.train.seed or 0), self.device,
                                  dtype=torch.float32)
        # lr_scheduler_interval 'epoch': the schedule sees the epoch index
        steps_per_epoch = None
        if str(hparams.get("lr_scheduler_interval", "step")) == "epoch":
            steps_per_epoch = max(
                1, _limit(len(train_pipe), self.train_limit)
                // max(1, self.grad_batches))
        optimizer, scheduler = build_optimizer(
            self.model.parameters(), hparams, steps_per_epoch=steps_per_epoch)
        self.state = init_state(self.model, optimizer, scheduler)
        self._detector = None   # built once, at the first validation

        ckpt_cfg = config.train.checkpoint
        self.ckpt = CheckpointManager(
            ckpt_cfg.dir, monitor=ckpt_cfg.monitor, mode=ckpt_cfg.mode)
        self.epoch_seconds: list = []   # wall-clock per epoch

    def _build_steps(self):
        hparams = self.config.model.hparams
        train_step = make_train_step(
            self.model, hparams, self.input_size,
            compute_dtype=self.compute_dtype, grad_batches=self.grad_batches,
            grad_clip_val=self.grad_clip_val, remat=self.remat,
            nan_guard=self.nan_guard)
        eval_step = make_eval_step(self.model, hparams, self.input_size,
                                   compute_dtype=self.compute_dtype)
        return train_step, eval_step

    def _to_device(self, batch) -> BatchData:
        def tensor(t):
            if torch.is_tensor(t):
                return t
            a = np.asarray(t)   # a read-only array (e.g. from JAX) is copied
            return torch.from_numpy(a if a.flags.writeable else a.copy())

        return BatchData(*(tensor(t).to(self.device, non_blocking=True)
                           for t in (batch.image, batch.boxes,
                                     batch.box_mask)))

    def _profile(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=activities)

    def fit(self, resume: bool = False) -> dict:
        state = self.state
        if resume and self.ckpt.has_checkpoint("last"):
            self.ckpt.restore(state, "last")
            print(f"Resumed from last checkpoint at step {state.step}")
        train_step, eval_step = self._build_steps()

        final = {}
        prof = self._profile() if self.profiler else contextlib.nullcontext()
        with prof:
            for epoch in range(self.epochs):
                self._epoch(epoch, state, train_step, eval_step, final)
        if self.profiler:
            os.makedirs("logs/profile", exist_ok=True)
            prof.export_chrome_trace("logs/profile/trace.json")

        self.metrics.flush()
        final["epoch"] = self.epochs - 1
        return final

    def _epoch(self, epoch, state, train_step, eval_step, final) -> None:
        n_train = _limit(len(self.train_pipe), self.train_limit)
        t0 = time.time()
        train_metrics = []
        val_every = (max(1, int(n_train * self.val_check_interval))
                     if isinstance(self.val_check_interval, float)
                     else int(self.val_check_interval))
        nan_hits = 0
        pending = []   # device-side metric dicts; one fetch per K steps
        for i, batch in enumerate(iter(self.train_pipe)):
            if i >= n_train:
                break
            m = train_step(state, self._to_device(batch))
            if self.nan_guard and not math.isfinite(float(m["loss"])):
                nan_hits += 1
                print(f"WARNING: non-finite loss at step {i} "
                      f"({nan_hits}/{self.nan_guard_retries}) — "
                      f"skipping batch"
                      + (", restoring last checkpoint"
                         if self.ckpt.has_checkpoint("last") else ""))
                if nan_hits > self.nan_guard_retries:
                    raise FloatingPointError(
                        "nan_guard: too many non-finite losses")
                if self.ckpt.has_checkpoint("last"):
                    self.ckpt.restore(state, "last")
                continue
            pending.append(m)
            if len(pending) >= self.log_every_n_steps:
                self._drain_metrics(pending, train_metrics)

            val_epoch = (epoch + 1) % self.check_val_every_n_epoch == 0
            if val_epoch and ((i + 1) % val_every == 0
                              or (i + 1) == n_train):
                # drain first so that the steps stay in order in the tsv
                self._drain_metrics(pending, train_metrics)
                val = self.validate(state, eval_step)
                self.metrics.log("val/loss", val["val_loss"])
                self.metrics.log("val/bbox_loss", val["val_bbox_loss"])
                self.metrics.log("val/obj_loss", val["val_obj_loss"])
                if "val_AP" in val:
                    self.metrics.log("val/AP", val["val_AP"])
                self.ckpt.save(state, epoch, val)
                final.update(val)

        self._drain_metrics(pending, train_metrics)
        tm = {k: float(np.mean([m[k] for m in train_metrics]))
              for k in _METRICS}
        final.update({f"train_{k}": v for k, v in tm.items()})
        self.metrics.set_epoch(epoch)
        self.epoch_seconds.append(time.time() - t0)
        print(f"epoch {epoch}: train_loss={tm['loss']:.5f} "
              f"val_loss={final.get('val_loss', float('nan')):.5f} "
              f"({self.epoch_seconds[-1]:.1f}s)")

    def _fetch(self, metrics) -> list:
        """The device-side metric dicts as rows of floats, in one host
        sync."""
        self._n_metric_syncs += 1
        return torch.stack([torch.stack([m[k].float() for k in _METRICS])
                            for m in metrics]).tolist()

    def _drain_metrics(self, pending, train_metrics) -> None:
        """Fetch all pending step metrics in one host sync and log them."""
        if not pending:
            return
        for values in self._fetch(pending):
            row = dict(zip(_METRICS, values))
            train_metrics.append(row)
            self.metrics.log("train/loss", row["loss"])
            self.metrics.log("train/bbox_loss", row["bbox_loss"])
            self.metrics.log("train/obj_loss", row["obj_loss"])
            self.metrics.next_step()
        pending.clear()

    def validate(self, state, eval_step) -> dict:
        """The validation loss over ``val_batches`` batches, and with
        ``eval_ap`` the AP of the detector (built once, run under the
        step's autocast)."""
        n_val = _limit(len(self.val_pipe), self.val_limit)
        ms = []
        ap_metric = None
        if self.eval_ap:
            from ..inference import make_detector
            ap_metric = MeanAveragePrecision()
            if self._detector is None:
                self._detector = make_detector(
                    self.model, self.config.model.hparams, self.input_size,
                    compute_dtype=self.compute_dtype)
        for i, batch in enumerate(iter(self.val_pipe)):
            if i >= n_val:
                break
            batch = self._to_device(batch)
            ms.append(eval_step(batch))
            if ap_metric is not None:
                self._update_ap(ap_metric, self._detector, batch)
        # one host fetch for the whole validation pass
        rows = self._fetch(ms) if ms else [[float("nan")] * len(_METRICS)]
        out = {f"val_{k}": float(np.mean([r[j] for r in rows]))
               for j, k in enumerate(_METRICS)}
        if ap_metric is not None:
            out["val_AP"] = ap_metric.compute()["map"]
        return out

    def _update_ap(self, ap_metric, detect, batch: BatchData) -> None:
        self.model.eval()
        with autocast(self.device, self.compute_dtype):
            det = detect(batch.image)
        add_detections(ap_metric, det, batch.boxes, batch.box_mask,
                       self.input_size)
