"""The ranks' side of tests/test_torch_spatial.py and
tests/test_torch_experts.py: functions that
``uavdet_tpu_torch.parallel.dryrun.launch`` runs in each process of a gloo
group on the CPU, on a data x fsdp x sp x ep mesh. They import torch and
the port only (no JAX), and return numpy arrays and numbers, which the
tests hold against one process in the test's own."""

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from tests.torch_dist_worker import ListPipe
from uavdet_tpu_torch.inference import make_detector
from uavdet_tpu_torch.models import DyYOLO
from uavdet_tpu_torch.models.baseline import BaselineModel
from uavdet_tpu_torch.models.dysoem_simfpn import DySOEM_SimFPN
from uavdet_tpu_torch.parallel import (coordinate, expert_params,
                                       full_expert_tensor, halo_exchange,
                                       local_batch_rows, make_mesh,
                                       shard_host_batch, shard_model,
                                       sp_group)
from uavdet_tpu_torch.parallel.spatial import conv2d_rows
from uavdet_tpu_torch.training import (CheckpointManager, MetricsWriter,
                                       Trainer, build_optimizer, init_state,
                                       make_train_step)
from uavdet_tpu_torch.utils.config import Config
from uavdet_tpu_torch.utils.datatypes import BatchData

F64 = torch.float64


def build(kind: str, state_dict, layer_config=None):
    """A plain model of ``kind`` ("dyyolo", "baseline", "dysoem") with
    ``state_dict``."""
    if kind == "dysoem":
        model = DySOEM_SimFPN()
    elif kind == "baseline":
        model = BaselineModel(layer_config)
    else:
        model = DyYOLO(layer_config, attn_temperature=30.0)
    model.load_state_dict(state_dict)
    return model


def full_state(model) -> dict:
    """Every parameter of a plain, DDP or FSDP2 model as whole numpy arrays
    (FSDP2's shards and ep's slices gathered: a collective), and its
    buffers."""
    from torch.distributed.tensor import DTensor
    inner = getattr(model, "module", model)
    out = {}
    for name, p in inner.named_parameters():
        if isinstance(p, DTensor):
            t = p.full_tensor()
        elif getattr(p, "ep_slice", None) is not None:
            t = full_expert_tensor(p)
        else:
            t = p
        out[name] = t.detach().numpy().copy()
    for name, b in inner.named_buffers():
        out[name] = b.detach().numpy().copy()
    return out


def _full_grad(p):
    from torch.distributed.tensor import DTensor
    g = p.grad
    if isinstance(g, DTensor):
        return g.full_tensor()
    if getattr(p, "ep_slice", None) is not None:
        return full_expert_tensor(g, p.ep_slice)
    return g


def mesh_steps(case: dict) -> tuple:
    """Train steps of ``case`` on its mesh: ``kind``, ``state_dict``,
    ``layer_config``, ``hp``, ``size``, ``batches`` (global numpy triples;
    each rank takes its rows, the step its band), ``axes`` (data, fsdp, sp,
    ep), ``grad_batches``, ``clip``, ``dtype``, ``fsdp`` -> (losses, the
    whole gradients of every update, the final state), and the train
    state."""
    mesh = make_mesh(*case["axes"], device_type="cpu")
    dtype = case.get("dtype", F64)
    model = build(case["kind"], case["state_dict"],
                  case.get("layer_config")).to(dtype)
    placed = shard_model(model, mesh, case.get("fsdp"))
    state = init_state(placed, *build_optimizer(placed.parameters(),
                                                case["hp"]))
    names = [n for n, _ in getattr(placed, "module", placed)
             .named_parameters()]
    grads, step_fn = [], state.optimizer.step

    def recording_step(*a, **kw):
        params = state.optimizer.param_groups[0]["params"]
        grads.append({n: _full_grad(p).detach().numpy().copy()
                      for n, p in zip(names, params)})
        return step_fn(*a, **kw)

    state.optimizer.step = recording_step
    step = make_train_step(placed, case["hp"], case["size"],
                           grad_batches=case.get("grad_batches", 1),
                           grad_clip_val=case.get("clip"), mesh=mesh)
    losses = []
    for arrays in case["batches"]:
        b = BatchData(*(torch.from_numpy(np.asarray(a)) for a in arrays))
        b = b._replace(image=b.image.to(dtype), boxes=b.boxes.to(dtype))
        b = shard_host_batch(b, local_batch_rows(mesh, len(arrays[0])))
        m = step(state, b)
        losses.append([float(m[k]) for k in ("loss", "bbox_loss",
                                               "obj_loss")])
    state.optimizer.step = step_fn
    slices = {n: tuple(p.shape) for n, p in getattr(placed, "module", placed)
              .named_parameters() if getattr(p, "ep_slice", None) is not None}
    return ({"losses": np.asarray(losses), "grads": grads,
             "final": full_state(placed), "slices": slices,
             "coordinate": coordinate(mesh),
             "rows": sorted(local_batch_rows(mesh, len(case["batches"][0][0])))},
            state)


def step_cases(cases: dict) -> dict:
    """Each case of ``cases`` (name -> ``mesh_steps``'s dict) from its own
    weights; a case with ``ckpt_dir`` also saves a checkpoint there, then
    restores ``restore_dir``'s (a one-process checkpoint) and reports the
    restored state."""
    out = {}
    for name, case in cases.items():
        out[name], state = mesh_steps(case)
        if case.get("ckpt_dir"):
            CheckpointManager(case["ckpt_dir"]).save(state, 0,
                                                     {"val_loss": 1.0})
            CheckpointManager(case["restore_dir"]).restore(state, "last")
            mine = state.optimizer.state
            out[name]["restored"] = full_state(state.model)
            out[name]["restored_momentum"] = {
                n: full_expert_tensor(mine[p]["momentum_buffer"], p.ep_slice)
                .numpy() for n, p in getattr(state.model, "module",
                                             state.model).named_parameters()
                if getattr(p, "ep_slice", None) is not None}
            out[name]["restored_step"] = (state.step, state.mini_step)
    return out


def _counting(calls: list, name: str, fn):
    def counted(*a, **kw):
        calls.append(name)
        return fn(*a, **kw)
    return counted


def detect_cases(cases: dict) -> dict:
    """Each case (name -> ``kind``, ``state_dict``, ``layer_config``,
    ``hp``, ``size``, ``axes``, ``frames`` or ``dual``, ``dtype``): the
    spatial detect of the model on the case's mesh -> its detections, and
    the calls it made of the halo exchange and of the stem and dyconv ops
    (their plain versions here)."""
    from uavdet_tpu_torch.ops import dyconv, stem
    from uavdet_tpu_torch.parallel import spatial
    out = {}
    for name, c in cases.items():
        mesh = make_mesh(*c["axes"], device_type="cpu")
        model = build(c["kind"], c["state_dict"], c.get("layer_config"))
        model = model.to(c.get("dtype", torch.float32)).eval()
        det = make_detector(model, c["hp"], c["size"], compute_dtype=c.get(
            "dtype", torch.float32), pre_nms_topk=c.get("topk", 64),
            max_det=16, mesh=mesh, spatial=True, dual="dual" in c)
        calls = []
        saved = (spatial.halo_exchange, stem.stem_l1_plain,
                 stem.stem_l2_plain, dyconv.dyconv_plain)
        spatial.halo_exchange = _counting(calls, "halo", saved[0])
        stem.stem_l1_plain = _counting(calls, "stem_l1", saved[1])
        stem.stem_l2_plain = _counting(calls, "stem_l2", saved[2])
        dyconv.dyconv_plain = _counting(calls, "dyconv", saved[3])
        try:
            got = det(*c["dual"]) if "dual" in c else det(c["frames"])
        finally:
            (spatial.halo_exchange, stem.stem_l1_plain, stem.stem_l2_plain,
             dyconv.dyconv_plain) = saved
        out[name] = [t.numpy() for t in got]
        out[name + " calls"] = {k: calls.count(k) for k in set(calls)}
    return out


def _rows(x, group, dim):
    """This rank's band of ``x`` on ``dim`` (bands of equal rows)."""
    r, n = dist.get_rank(group), dist.get_world_size(group)
    h = x.shape[dim] // n
    return x.narrow(dim, r * h, h)


def halo_cases(seed: int) -> dict:
    """``conv2d_rows`` of a band against the whole image's conv, forward and
    backward (the band of each rank: so the image's top and bottom edges
    and the blocks' boundaries), for 3x3 convs of stride 1 and 2 and a 1x1
    of stride 2, float64; and ``halo_exchange`` of 2 rows above and 1
    below on NHWC uint8 frames against the frames' rows. -> the largest
    differences."""
    mesh = make_mesh(1, 1, dist.get_world_size(), 1, device_type="cpu")
    group = sp_group(mesh)
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 5, 16, 12, generator=gen, dtype=F64)
    out = {}
    for k, stride, pad in ((3, 1, 1), (3, 2, 1), (1, 2, 0)):
        w = torch.randn(7, 5, k, k, generator=gen, dtype=F64)
        b = torch.randn(7, generator=gen, dtype=F64)
        y = F.conv2d(x, w, b, stride, pad)
        dy = torch.randn(y.shape, generator=gen, dtype=F64)
        xf = x.clone().requires_grad_()
        (F.conv2d(xf, w, b, stride, pad) * dy).sum().backward()
        xb = _rows(x, group, 2).clone().requires_grad_()
        wb = w.clone().requires_grad_()
        yb = conv2d_rows(xb, wb, b, stride, pad, sp_group=group)
        (yb * _rows(dy, group, 2)).sum().backward()
        # the weight's gradient: the bands' terms summed over the group
        dw = wb.grad.clone()
        dist.all_reduce(dw, group=group)
        wf = w.clone().requires_grad_()
        (F.conv2d(x, wf, b, stride, pad) * dy).sum().backward()
        out[f"{k}x{k} s{stride}"] = {
            "forward": float((yb - _rows(y, group, 2)).abs().max()),
            "input_grad": float((xb.grad - _rows(xf.grad, group, 2))
                                .abs().max()),
            "weight_grad": float((dw - wf.grad).abs().max()),
            "rows": yb.shape[2]}
    frames = torch.randint(0, 256, (2, 16, 10, 3), generator=gen,
                           dtype=torch.uint8)
    band = _rows(frames, group, 1)
    got = halo_exchange(band, 2, 1, group, dim=1)
    r, n = dist.get_rank(group), dist.get_world_size(group)
    h = 16 // n
    pad = torch.cat([torch.zeros_like(frames[:, :2]), frames,
                     torch.zeros_like(frames[:, :1])], dim=1)
    want = pad[:, r * h:r * h + h + 3]
    out["uint8 halo"] = {"equal": bool(torch.equal(got, want))}
    return out


def trainer_fit(config: dict, train, val, workdir) -> dict:
    """``Trainer.fit`` of ``config`` on the running group (the weights
    seeded by ``train.seed``) -> its final float metrics and the slices'
    shapes of the trained model."""
    t = Trainer(Config(config), ListPipe(train), ListPipe(val),
                metrics=MetricsWriter(os.path.join(
                    workdir, f"dv{dist.get_rank()}")), device="cpu")
    final = t.fit()
    return {"final": {k: v for k, v in final.items()
                      if isinstance(v, float)},
            "mesh": dict(zip(t.mesh.mesh_dim_names, t.mesh.shape)),
            "slices": len(expert_params(t.model)),
            "step": t.state.step}


def job(spec: dict) -> dict:
    """Everything one group of a test module runs: the step cases, the
    spatial detect cases, the halo checks and the Trainers, each where the
    spec names them."""
    out = {}
    if spec.get("steps"):
        out["steps"] = step_cases(spec["steps"])
    if spec.get("detect"):
        out["detect"] = detect_cases(spec["detect"])
    if spec.get("halo_seed") is not None:
        out["halo"] = halo_cases(spec["halo_seed"])
    if spec.get("trainers"):
        out["trainers"] = {name: trainer_fit(cfg, spec["train"], spec["val"],
                                             spec["workdir"])
                           for name, cfg in spec["trainers"].items()}
    return out
