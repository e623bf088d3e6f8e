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
is accepted and changes nothing.

Multi-device keys, with the JAX meaning: ``devices`` is the total, data x
fsdp x sp x ep, ``fsdp_devices``, ``sp_devices`` and ``ep_devices`` its
factors (``devices`` must be divisible by their product, the batch size by
data x fsdp x ep, and under ``sp`` the image size by sp x the model's
largest stride); ``multihost`` (with
``coordinator``, ``num_processes``, ``process_id`` where
``torch.distributed.run``'s environment does not give them) starts the
process group. One process drives one device: with ``devices`` above 1 the
trainer joins the running process group, or starts it from the
environment or from those keys, and trains on a ``parallel.make_mesh``
mesh (DDP, FSDP2 or HSDP, ``parallel.shard_model``; every conv on the
rank's band of rows under ``sp``, the expert stacks sliced under ``ep``)
where the world has
``devices`` ranks; with fewer it warns and trains on one device, as the JAX
trainer does. With ``multihost`` the train pipeline decodes only this
rank's rows (``set_local_rows``); otherwise every rank takes the global
batch and keeps its rows. Validation gives every rank the full batch: the
loss is over each rank's rows, reduced by rows, and the AP gathers every
rank's detections (the sharded detect) so that every rank holds the same
metric. Under FSDP2 or ``ep`` validation runs on a plain copy of the model
whose weights (FSDP2's shards, ``ep``'s slices) are gathered once per
validation pass; under ``sp`` the validation loss runs on each rank's band
of rows and the detector is the spatial one (``make_detector(mesh=,
spatial=True)``). Rank 0 writes the checkpoints and the metrics.

``pp_devices`` above 1 (with ``pp_microbatches``, ``pp_devices`` unless
set) trains in one process over S = ``pp_devices`` stage devices
(``parallel.pipeline``): ``device="cuda"`` takes ``cuda:0`` to
``cuda:{S-1}``, ``device="cpu"`` S stages on the CPU, a list of S devices
is taken as given (two stages may share a card). Each batch is cut into
``pp_microbatches`` microbatches that stream through the stages; ``remat``
has no effect there (the JAX pp step takes none). It refuses what the JAX
trainer refuses: ``multihost``, fsdp, sp or ep above 1, ``devices`` other
than 1 or ``pp_devices``, a batch size that ``pp_microbatches`` does not
divide, fewer CUDA devices than stages; and models without a
``layer_config``. Validation and the AP run on a plain copy of the model on
the first stage's device, filled once per validation pass. The optimizer
runs over the model's parameters in the whole model's order, so a pp
checkpoint is the single-device one and each restores into the other (the
JAX pp checkpoint is its packed form).

The model is built at construction with float32 parameters and seeded
weights (``train.seed``, ``utils.seeding.init_weights``); ``fit`` trains it
from its current weights, so a caller may load others into
``trainer.model`` first. ``train_pipe`` and ``val_pipe`` are iterables with
``len()`` whose items have ``image``, ``boxes`` and ``box_mask`` (numpy
arrays or tensors), such as ``data.DataPipeline``; the trainer moves them
to its device (a pipeline on the same device hands them over there).
"""

import contextlib
import copy
import math
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops.map import MeanAveragePrecision, add_detections
from ..parallel import (PipelinedModel, check_batch_divisible,
                        check_layout_supported, copy_full_weights,
                        init_multihost, local_batch_rows, local_device,
                        make_mesh, make_pp_eval_step, make_pp_trainer_step,
                        model_stride, row_band, shard_host_batch, shard_model,
                        stage_devices)
from ..utils.datatypes import BatchData
from ..utils.seeding import seeded_model
from .checkpoint import CheckpointManager
from .dvclive_io import MetricsWriter
from .optim import build_optimizer
from .steps import (REMAT_POLICIES, autocast, init_state, make_eval_step,
                    make_train_step)

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
        check_layout_supported(sp=tcfg.get("sp_devices", 1),
                               ep=tcfg.get("ep_devices", 1),
                               pp=tcfg.get("pp_devices", 1))
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
        self.multihost = bool(tcfg.get("multihost", False))
        self.n_pp = int(tcfg.get("pp_devices", 1) or 1)
        self.pp_microbatches = (int(tcfg.get("pp_microbatches", 0) or 0)
                                or self.n_pp)
        stages = None
        if self.n_pp > 1:   # one process, no process group
            stages = self._pp_stage_devices(tcfg, device)
            self.mesh, self.device = None, stages[0]
        else:
            self.mesh = self._make_mesh(tcfg, device)
            self.device = (local_device(device) if self.mesh is not None
                           else torch.device(device))

        hparams = config.model.hparams
        self.model = seeded_model(config.model.name, hparams,
                                  int(config.train.seed or 0), self.device,
                                  dtype=torch.float32)
        # the model the steps run: placed on the mesh; validation and the
        # detector run a plain module with the full weights (the model
        # itself under DDP, a copy under FSDP2, ep and pp)
        self.train_model = self.model
        self.eval_model = self.model
        self.train_rows = self.val_rows = None
        self.pm = None
        if stages is not None:
            self.pm = PipelinedModel(self.model, self.n_pp, stages)
            self.eval_model = self.pm.eval_model
        elif self.mesh is not None:
            bs = int(config.dataset.batch_size)
            check_batch_divisible(bs, self.mesh)
            if self.mesh["sp"].size() > 1:
                row_band(0, self.mesh["sp"].size(), self.input_size,
                         model_stride(self.model))
            self.train_rows = self.val_rows = local_batch_rows(self.mesh, bs)
            if self.mesh["fsdp"].size() > 1 or self.mesh["ep"].size() > 1:
                self.eval_model = copy.deepcopy(self.model)
            self.train_model = shard_model(self.model, self.mesh)
            if self.multihost and hasattr(train_pipe, "set_local_rows"):
                # the pipeline yields this rank's rows alone
                if train_pipe.set_local_rows(self.train_rows):
                    self.train_rows = None
        # lr_scheduler_interval 'epoch': the schedule sees the epoch index
        steps_per_epoch = None
        if str(hparams.get("lr_scheduler_interval", "step")) == "epoch":
            steps_per_epoch = max(
                1, _limit(len(train_pipe), self.train_limit)
                // max(1, self.grad_batches))
        optimizer, scheduler = build_optimizer(
            self.train_model.parameters(), hparams,
            steps_per_epoch=steps_per_epoch)
        self.state = init_state(self.train_model, optimizer, scheduler)
        self._detector = None   # built once, at the first validation

        ckpt_cfg = config.train.checkpoint
        self.ckpt = CheckpointManager(
            ckpt_cfg.dir, monitor=ckpt_cfg.monitor, mode=ckpt_cfg.mode)
        self.epoch_seconds: list = []   # wall-clock per epoch

    def _pp_stage_devices(self, tcfg, device) -> list:
        """The stage devices of ``pp_devices``, after the JAX trainer's
        refusals (``uavdet_tpu/training/trainer.py``)."""
        n_pp = self.n_pp
        if self.multihost:
            raise ValueError("train.trainer.pp_devices > 1 is single-process "
                             "only (multihost pipeline stages unsupported)")
        inner = math.prod(int(tcfg.get(k, 1) or 1) for k in (
            "fsdp_devices", "sp_devices", "ep_devices"))
        if inner > 1:
            raise ValueError(
                "train.trainer.pp_devices > 1 cannot combine with fsdp/sp/ep:"
                " pipeline parallelism runs its stages in one process "
                "(parallel.pipeline)")
        n_devices = int(tcfg.get("devices", 1) or 1)
        if n_devices not in (1, n_pp):
            raise ValueError(f"train.trainer.devices={n_devices} must equal "
                             f"pp_devices={n_pp} (or be left at 1)")
        bs = int(self.config.dataset.batch_size)
        if bs % self.pp_microbatches:
            raise ValueError(f"dataset.batch_size={bs} must be divisible by "
                             f"pp_microbatches={self.pp_microbatches}")
        return stage_devices(device, n_pp)

    def _make_mesh(self, tcfg, device):
        """The data x fsdp x sp x ep mesh of ``devices``, or None (one
        device)."""
        n_devices = int(tcfg.get("devices", 1) or 1)
        n_fsdp = int(tcfg.get("fsdp_devices", 1) or 1)
        n_sp = int(tcfg.get("sp_devices", 1) or 1)
        n_ep = int(tcfg.get("ep_devices", 1) or 1)
        if not (self.multihost or n_devices > 1):
            return None
        running = init_multihost(
            coordinator=tcfg.get("coordinator"),
            num_processes=tcfg.get("num_processes"),
            process_id=tcfg.get("process_id"), device=device)
        world = dist.get_world_size() if running else 1
        inner = n_fsdp * n_sp * n_ep
        if n_devices % inner:
            raise ValueError(
                f"train.trainer.devices={n_devices} is not divisible by "
                f"fsdp_devices*sp_devices*ep_devices={inner}")
        if not running or world < n_devices:
            if n_devices > 1:
                print(f"WARNING: train.trainer.devices={n_devices} but only "
                      f"{world} process(es) run; running single-device")
            return None
        if world > n_devices:
            raise ValueError(
                f"train.trainer.devices={n_devices} but {world} processes "
                "run: one process drives one device")
        return make_mesh(n_devices // inner, n_fsdp, n_sp, n_ep,
                         "cuda" if torch.device(device).type == "cuda"
                         else "cpu")

    @property
    def rank(self) -> int:
        return dist.get_rank() if self.mesh is not None else 0

    def _build_steps(self):
        hparams = self.config.model.hparams
        if self.pm is not None:
            return (make_pp_trainer_step(
                self.pm, hparams, self.input_size, self.pp_microbatches,
                compute_dtype=self.compute_dtype,
                grad_batches=self.grad_batches,
                grad_clip_val=self.grad_clip_val, nan_guard=self.nan_guard),
                make_pp_eval_step(self.pm, hparams, self.input_size,
                                  compute_dtype=self.compute_dtype))
        train_step = make_train_step(
            self.train_model, hparams, self.input_size,
            compute_dtype=self.compute_dtype, grad_batches=self.grad_batches,
            grad_clip_val=self.grad_clip_val, remat=self.remat,
            nan_guard=self.nan_guard, mesh=self.mesh)
        eval_step = make_eval_step(self.eval_model, hparams, self.input_size,
                                   compute_dtype=self.compute_dtype,
                                   mesh=self.mesh)
        return train_step, eval_step

    def _to_device(self, batch, rows=None) -> BatchData:
        """The batch on the trainer's device; with ``rows`` (the rows this
        rank holds of a global batch) those rows alone."""
        if rows is not None:
            batch = shard_host_batch(batch, rows)

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
        if self.profiler and self.rank == 0:
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
            m = train_step(state, self._to_device(batch, self.train_rows))
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
        if self.eval_model is not self.model:   # FSDP2, ep, pp
            copy_full_weights(self.train_model, self.eval_model)
        if self.eval_ap:
            from ..inference import make_detector
            ap_metric = MeanAveragePrecision()
            if self._detector is None:
                self._detector = make_detector(
                    self.eval_model, self.config.model.hparams,
                    self.input_size, compute_dtype=self.compute_dtype,
                    mesh=self.mesh, spatial=self.mesh is not None
                    and self.mesh["sp"].size() > 1)
        for i, batch in enumerate(iter(self.val_pipe)):
            if i >= n_val:
                break
            batch = self._to_device(batch)
            ms.append(eval_step(batch if self.val_rows is None else
                                shard_host_batch(batch, self.val_rows)))
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
        """``batch`` is the global batch: on a mesh the detector gathers
        every rank's detections, so the metric is the same on every
        rank."""
        self.eval_model.eval()
        with autocast(self.device, self.compute_dtype):
            det = detect(batch.image)
        add_detections(ap_metric, det, batch.boxes, batch.box_mask,
                       self.input_size)
