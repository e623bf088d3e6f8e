"""Checkpoints with the best/last policy: ``uavdet_tpu/training/checkpoint.py``
with ``torch.save`` in place of Orbax.

``save`` writes ``last`` every time, and ``best-{epoch:02d}-{value:.4f}``
when the monitored value is the best so far (``mode`` min or max),
deleting the previous best; ``meta.json`` keeps the best value and name
across runs. Each checkpoint is a directory holding ``state.pt``: the
model's parameters and buffers (the BatchNorm running statistics among
them), the optimizer's and the scheduler's state, the step, and where the
accumulation stands (``mini_step`` and the gradients accumulated so far).

A model split into ``pp`` stages (``parallel.PipelinedModel``) is one
module whose tensors lie on the stages' devices: its checkpoint is the
single-device one, key for key and index for index, and each restores into
the other.

On a mesh (a model placed by ``parallel.shard_model``) there is one format
all the same. Rank 0 writes the full state: the model without DDP's
``module.`` prefix and with FSDP2's shards gathered, the optimizer's state
keyed by parameter index as a one-process optimizer keeps it
(``torch.distributed.checkpoint.state_dict``, full and on the CPU), the
scheduler; the other ranks wait at a barrier. A restore loads on rank 0
and broadcasts. So a checkpoint of two ranks restores in one process and
the other way round. Gradients accumulated under DDP are averaged over the
ranks before they are written (the update to come averages them anyway);
under FSDP2 they live unsharded inside its modules until the update, so a
checkpoint taken between the microbatches of an update keeps none of them
and restarts the accumulation (a warning says so).
"""

import json
import os
import shutil
from typing import Optional

import torch
import torch.distributed as dist

from ..parallel.experts import (cut_expert_tensor, expert_params,
                                full_expert_tensor)
from ..parallel.mesh import is_ddp, is_fsdp, unwrap
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
        if _on_mesh(state.model):
            blob = _gathered_blob(state)
            if dist.get_rank() == 0:
                _write(blob, path)
            dist.barrier()
            return
        params = list(state.model.parameters())
        blob = {"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "scheduler": state.scheduler.state_dict(),
                "step": state.step, "mini_step": state.mini_step,
                "grads": [p.grad for p in params]}
        _write(blob, path)

    def save(self, state: TrainState, epoch: int, metrics: dict) -> bool:
        """Save last and, if the monitored value is the best, best; -> True
        if it is a new best. On a mesh every rank calls it with the same
        metrics; rank 0 writes."""
        writer = not _on_mesh(state.model) or dist.get_rank() == 0
        self._save(state, os.path.join(self.ckpt_dir, "last"))
        value = float(metrics[self.monitor])
        is_best = self._is_better(value)
        if is_best:
            name = f"best-{epoch:02d}-{value:.4f}"
            if self.best_path and writer:
                old = os.path.join(self.ckpt_dir, self.best_path)
                if os.path.exists(old):
                    shutil.rmtree(old)
            self._save(state, os.path.join(self.ckpt_dir, name))
            self.best_value, self.best_path = value, name
        if writer:
            with open(self._meta_path, "w") as f:
                json.dump({"best_value": self.best_value,
                           "best_path": self.best_path, "epoch": epoch}, f)
        return is_best

    def restore(self, state: TrainState, name: str = "last") -> TrainState:
        """Load the named checkpoint into ``state`` (its model, optimizer
        and scheduler, in place, each tensor on its parameter's device, the
        stages' devices under ``pp``) and return it. On a mesh rank 0 reads
        it and broadcasts it to the others."""
        if _on_mesh(state.model):
            return _restore_broadcast(
                state, os.path.join(self.ckpt_dir, name, _FILE))
        device = next(state.model.parameters()).device
        blob = torch.load(os.path.join(self.ckpt_dir, name, _FILE),
                          map_location=device, weights_only=True)
        state.model.load_state_dict(blob["model"])
        state.optimizer.load_state_dict(blob["optimizer"])
        state.scheduler.load_state_dict(blob["scheduler"])
        for p, g in zip(state.model.parameters(), blob["grads"], strict=True):
            p.grad = None if g is None else g.to(p.device)   # pp: per stage
        state.step, state.mini_step = blob["step"], blob["mini_step"]
        return state

    def has_checkpoint(self, name: str = "last") -> bool:
        return os.path.exists(os.path.join(self.ckpt_dir, name))


def _write(blob: dict, path: str) -> None:
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    torch.save(blob, os.path.join(path, _FILE))


def _on_mesh(model) -> bool:
    return is_ddp(model) or is_fsdp(model)


def _names(model) -> list:
    """The parameters' names in the order of a one-process optimizer's
    indices (``build_optimizer(model.parameters())``)."""
    return [n for n, _ in unwrap(model).named_parameters()]


def _opts(**kw):
    from torch.distributed.checkpoint.state_dict import StateDictOptions
    return StateDictOptions(full_state_dict=True, **kw)


def _gathered_blob(state: TrainState) -> dict:
    """The full checkpoint of a placed model, on rank 0 (a collective:
    every rank calls it)."""
    from torch.distributed.checkpoint.state_dict import (
        get_model_state_dict, get_optimizer_state_dict)
    model = state.model
    msd = get_model_state_dict(model, options=_opts(cpu_offload=True))
    osd = get_optimizer_state_dict(model, state.optimizer,
                                   options=_opts(cpu_offload=True))
    params = list(unwrap(model).parameters())
    slices = _slices(model)
    for name, p in slices.items():   # the whole stacks; every rank gathers
        msd[name] = full_expert_tensor(p).cpu()
        live = state.optimizer.state.get(p, {})
        for k in sorted(live):
            v = live[k]
            if torch.is_tensor(v) and v.shape == p.shape:
                full = full_expert_tensor(v, p.ep_slice).cpu()
                if name in osd.get("state", {}):
                    osd["state"][name][k] = full
    mini_step, grads = state.mini_step, [None] * len(params)
    if mini_step and (is_fsdp(model) or slices):
        print("WARNING: checkpoint between the microbatches of an update "
              f"under fsdp or ep: the {mini_step} accumulated microbatches "
              "are not kept; a restore starts the accumulation anew")
        mini_step = 0
    elif mini_step:
        for i, p in enumerate(params):
            if p.grad is not None:
                g = p.grad.clone()
                dist.all_reduce(g)
                grads[i] = (g / dist.get_world_size()).cpu()
    if dist.get_rank() != 0:
        return {}
    index = {n: i for i, n in enumerate(_names(model))}
    osd = {"state": {index[k]: v for k, v in osd["state"].items()},
           "param_groups": [dict(g, params=[index[k] for k in g["params"]])
                            for g in osd["param_groups"]]}
    return {"model": msd, "optimizer": osd,
            "scheduler": state.scheduler.state_dict(), "step": state.step,
            "mini_step": mini_step, "grads": grads}


def _slices(model) -> dict:
    """The ``ep`` expert slices of a placed model, by name."""
    mine = {id(p) for p in expert_params(unwrap(model))}
    return {n: p for n, p in unwrap(model).named_parameters()
            if id(p) in mine}


def _restore_broadcast(state: TrainState, path: str) -> TrainState:
    from torch.distributed.checkpoint.state_dict import (
        set_model_state_dict, set_optimizer_state_dict)
    from torch.distributed.tensor import DTensor, distribute_tensor
    model = state.model
    blob = (torch.load(path, map_location="cpu", weights_only=True)
            if dist.get_rank() == 0 else None)
    osd = {}
    slices = _slices(model)
    whole = [None]   # the stacks of the slices and their optimizer state
    if blob is not None:
        names = _names(model)
        osd = {"state": {names[k]: v
                         for k, v in blob["optimizer"]["state"].items()},
               "param_groups": [
                   dict(g, params=[names[k] for k in g["params"]])
                   for g in blob["optimizer"]["param_groups"]]}
        whole = [{n: (blob["model"].pop(n), osd["state"].pop(n, {}))
                  for n in slices}]
    opts = _opts(broadcast_from_rank0=True, strict=not slices)
    set_model_state_dict(model, blob["model"] if blob else {}, options=opts)
    set_optimizer_state_dict(model, state.optimizer, osd, options=opts)
    if slices:
        dist.broadcast_object_list(whole, src=0)
        with torch.no_grad():
            for name, p in slices.items():
                full, st = whole[0][name]
                p.copy_(cut_expert_tensor(full, p.ep_slice))
                mine = state.optimizer.state[p]
                for k, v in st.items():
                    mine[k] = (cut_expert_tensor(v, p.ep_slice).to(p.device)
                               if torch.is_tensor(v) and v.dim() else v)
    rest = [None if blob is None else
            (blob["scheduler"], blob["step"], blob["mini_step"],
             blob["grads"])]
    dist.broadcast_object_list(rest, src=0)
    sched, state.step, state.mini_step, grads = rest[0]
    state.scheduler.load_state_dict(sched)
    for p, g in zip(unwrap(model).parameters(), grads, strict=True):
        if g is None:
            p.grad = None
        elif isinstance(p, DTensor):
            p.grad = distribute_tensor(g.to(p.device), p.device_mesh,
                                       p.placements)
        else:
            p.grad = g.to(p.device)
    return state
