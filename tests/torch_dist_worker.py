"""The ranks' side of tests/test_torch_parallel.py and
tests/test_torch_multihost.py: functions that
``uavdet_tpu_torch.parallel.dryrun.launch`` runs in each process of a gloo
group on the CPU. They import torch and the port only (no JAX: a process
that imports it pays seconds for nothing), and return numpy arrays and
numbers, which the tests hold against one process in the test's own."""

import copy
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from uavdet_tpu_torch.inference import make_detector, make_rtm_detector
from uavdet_tpu_torch.models import DyYOLO
from uavdet_tpu_torch.models.rtm_uav_det import RTM_ANCHORS, RTMUAVDet
from uavdet_tpu_torch.parallel import (copy_full_weights, init_multihost,
                                       local_batch_rows, make_mesh,
                                       shard_host_batch, shard_model)
from uavdet_tpu_torch.training import (CheckpointManager, MetricsWriter,
                                       Trainer, build_optimizer, init_state,
                                       make_eval_step, make_train_step)
from uavdet_tpu_torch.utils.config import Config
from uavdet_tpu_torch.utils.datatypes import BatchData


def full_params(model) -> dict:
    """Every parameter of a plain, DDP or FSDP2 model as full numpy arrays
    (a collective under FSDP2), and its BatchNorm buffers."""
    from torch.distributed.tensor import DTensor
    inner = getattr(model, "module", model)
    out = {}
    for name, p in inner.named_parameters():
        out[name] = (p.full_tensor() if isinstance(p, DTensor)
                     else p).detach().numpy().copy()
    for name, b in inner.named_buffers():
        out[name] = b.detach().numpy().copy()
    return out


def run_steps(model, hp, size, batches, grad_batches=1, mesh=None,
              grad_clip_val=None, dtype=torch.float32):
    """Train steps over ``batches`` (global numpy triples; on a mesh each
    rank takes its rows) -> (losses, the gradients of every update as full
    arrays, the final parameters and buffers)."""
    model = model.to(dtype)
    placed = model if mesh is None else shard_model(model, mesh)
    state = init_state(placed, *build_optimizer(placed.parameters(), hp))
    grads = []
    step_fn = state.optimizer.step
    names = [n for n, _ in getattr(placed, "module", placed)
             .named_parameters()]

    def recording_step(*a, **kw):
        from torch.distributed.tensor import DTensor
        grads.append({n: (p.grad.full_tensor() if isinstance(p.grad, DTensor)
                          else p.grad).numpy().copy()
                      for n, p in zip(names, state.optimizer.param_groups[0]
                                      ["params"])})
        return step_fn(*a, **kw)

    state.optimizer.step = recording_step
    step = make_train_step(placed, hp, size, grad_batches=grad_batches,
                           mesh=mesh, grad_clip_val=grad_clip_val)
    losses = []
    for arrays in batches:
        b = BatchData(*(torch.from_numpy(np.asarray(a)) for a in arrays))
        b = b._replace(image=b.image.to(dtype), boxes=b.boxes.to(dtype))
        if mesh is not None:
            b = shard_host_batch(b, local_batch_rows(mesh, len(arrays[0])))
        m = step(state, b)
        losses.append([float(m[k]) for k in ("loss", "bbox_loss",
                                               "obj_loss")])
    return np.asarray(losses), grads, full_params(placed), state


def step_cases(state_dict, hp, size, cases, ckpt_dir) -> dict:
    """Each case ``(name, n_fsdp, batches, grad_batches)`` from the same
    weights on a fresh model; then the checkpoint round trips of FSDP2 (the
    case "fsdp") and DDP (the case "ddp"): a two-rank save into
    ``ckpt_dir/two`` (``two_ddp``), and a restore of the one-process
    checkpoint ``ckpt_dir/one``."""
    out = {}
    for name, n_fsdp, batches, grad_batches, clip, dtype in cases:
        mesh = make_mesh(dist.get_world_size() // n_fsdp, n_fsdp,
                         device_type="cpu")
        model = DyYOLO(hp.layer_config, attn_temperature=30.0)
        model.load_state_dict(state_dict)
        losses, grads, final, state = run_steps(
            model, hp, size, batches, grad_batches, mesh, clip, dtype)
        out[name] = {"losses": losses, "grads": grads, "final": final}
        if name in ("fsdp", "ddp"):
            mgr = CheckpointManager(os.path.join(
                ckpt_dir, "two" if name == "fsdp" else "two_ddp"))
            mgr.save(state, 0, {"val_loss": 1.0})
            out[f"{name}_saved"] = full_params(state.model)
            mgr = CheckpointManager(os.path.join(ckpt_dir, "one"))
            mgr.restore(state, "last")
            out[f"{name}_restored"] = full_params(state.model)
            out[f"{name}_restored_step"] = (state.step, state.mini_step)
    return out


RTM_SCALES = (16, 8)   # an RTMUAVDet's heads at 64 px


def rtm_model(state_dict) -> RTMUAVDet:
    model = RTMUAVDet(RTM_ANCHORS, det_scales=RTM_SCALES)
    model.load_state_dict(state_dict)
    return model.eval()


def detect_cases(state_dict, hp, size, frames, dual, rtm_state_dict) -> dict:
    """The sharded detect of a plain model over ``frames`` (and with
    ``dual`` the pair) on the running group; over one frame with fewer
    candidates than ``max_det`` (a rank without rows); and of an
    RTMUAVDet, over ``frames`` and one frame, with ``pre_nms_topk`` below
    ``max_det``."""
    mesh = make_mesh(dist.get_world_size(), device_type="cpu")
    model = DyYOLO(hp.layer_config, attn_temperature=30.0)
    model.load_state_dict(state_dict)
    model.eval()
    out = {}
    det = make_detector(model, hp, size, compute_dtype=torch.float32,
                        pre_nms_topk=64, max_det=16, mesh=mesh)
    out["single"] = [t.numpy() for t in det(frames)]
    det = make_detector(model, hp, size, compute_dtype=torch.float32,
                        pre_nms_topk=64, max_det=16, mesh=mesh, dual=True)
    out["dual"] = [t.numpy() for t in det(*dual)]
    det = make_detector(model, hp, size, compute_dtype=torch.float32,
                        pre_nms_topk=8, max_det=16, mesh=mesh)
    out["single_one_frame"] = [t.numpy() for t in det(frames[:1])]
    det = make_rtm_detector(rtm_model(rtm_state_dict), size, RTM_SCALES,
                            pre_nms_topk=8, max_det=16, mesh=mesh)
    out["rtm"] = [t.numpy() for t in det(frames)]
    out["rtm_one_frame"] = [t.numpy() for t in det(frames[:1])]
    return out


class ListPipe:
    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def trainer_fit(config: dict, train, val, workdir) -> dict:
    """``Trainer.fit`` of ``config`` on the running group over the global
    batches ``train`` and ``val`` (the weights seeded by ``train.seed``, as
    in one process); -> the final float metrics."""
    t = Trainer(Config(copy.deepcopy(config)), ListPipe(train),
                ListPipe(val), metrics=MetricsWriter(os.path.join(
                    workdir, f"dv{dist.get_rank()}")), device="cpu")
    final = t.fit()
    return {k: v for k, v in final.items() if isinstance(v, float)}


def two_rank_job(spec: dict) -> dict:
    """Everything tests/test_torch_parallel.py checks on two ranks, in one
    process group."""
    out = {"steps": step_cases(spec["state_dict"], spec["hp"], spec["size"],
                               spec["cases"], spec["ckpt_dir"])}
    # FSDP2 over a model whose conv weights are channels_last, as the
    # card's are
    _, n_fsdp, batches, grad_batches, clip, dtype = next(
        c for c in spec["cases"] if c[0] == "fsdp")
    model = DyYOLO(spec["hp"].layer_config, attn_temperature=30.0)
    model.load_state_dict(spec["state_dict"])
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.to(memory_format=torch.channels_last)
    out["fsdp_channels_last"] = run_steps(
        model, spec["hp"], spec["size"], batches, grad_batches,
        make_mesh(1, n_fsdp, device_type="cpu"), clip, dtype)[2]
    jax_mesh = make_mesh(dist.get_world_size(), device_type="cpu")
    model = DyYOLO(spec["jax_hp"].layer_config, attn_temperature=30.0)
    model.load_state_dict(spec["jax_state_dict"])
    losses, _, final, _ = run_steps(model, spec["jax_hp"], spec["size"],
                                    [spec["jax_batch"]], mesh=jax_mesh)
    out["jax_case"] = {"losses": losses, "final": final}
    out["detect"] = detect_cases(spec["state_dict"], spec["hp"],
                                 spec["size"], spec["frames"], spec["dual"],
                                 spec["rtm_state_dict"])
    return out


def multihost_job(spec: dict) -> dict:
    """tests/test_torch_multihost.py's ranks: ``Trainer.fit`` with
    ``multihost: true`` over CPU pipelines (the train pipeline decodes this
    rank's rows alone: its full-file reads are counted), then the trainers
    of ``spec["trainer_configs"]`` over fixed global batches."""
    from uavdet_tpu_torch.data import DataPipeline
    from uavdet_tpu_torch.parallel import local_device
    assert init_multihost() is True   # the running group, not a new one
    assert local_device("cpu") == torch.device("cpu")
    tr = DataPipeline(spec["train_records"], spec["size"], 4, train=True,
                      seed=1, device="cpu")
    va = DataPipeline(spec["val_records"], spec["size"], 4, train=False,
                      seed=2, device="cpu")
    reads = []
    read = tr._read

    def counted(path):
        reads.append(path)
        return read(path)

    tr._read = counted
    workdir = spec["workdir"]
    t = Trainer(Config(copy.deepcopy(spec["multihost_config"])), tr, va,
                metrics=MetricsWriter(os.path.join(
                    workdir, f"dv{dist.get_rank()}")), device="cpu")
    final = t.fit()
    out = {"final": {k: v for k, v in final.items()
                     if isinstance(v, float)},
           "local_rows": sorted(tr.local_rows), "reads": reads,
           "batches": len(tr)}
    out["trainer"] = {name: trainer_fit(cfg, spec["train"], spec["val"],
                                        workdir)
                      for name, cfg in spec["trainer_configs"].items()}
    return out


def coordinator_rank(config: dict, workdir: str) -> dict:
    """A process that no launcher started a group for: the ``Trainer``
    starts it from the ``coordinator``, ``num_processes`` and
    ``process_id`` of ``config``; -> what the group is."""
    rank = config["train"]["trainer"]["process_id"]
    t = Trainer(Config(copy.deepcopy(config)), ListPipe([]), ListPipe([]),
                metrics=MetricsWriter(os.path.join(workdir,
                                                   f"dv_coord{rank}")),
                device="cpu")
    total = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(total)
    out = {"rank": dist.get_rank(), "world": dist.get_world_size(),
           "backend": dist.get_backend(), "mesh": t.mesh.size(),
           "sum": float(total), "again": init_multihost(device="cpu"),
           "rows": sorted(local_batch_rows(t.mesh, 4))}
    dist.destroy_process_group()
    return out


if __name__ == "__main__":
    # python -m tests.torch_dist_worker SPEC OUT: coordinator_rank(**SPEC)
    torch.save(coordinator_rank(**torch.load(sys.argv[1],
                                             weights_only=False)),
               sys.argv[2])
