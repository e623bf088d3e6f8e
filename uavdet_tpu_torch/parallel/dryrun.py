"""Process launcher and the port's ``dryrun_multichip``.

``launch(target, world, args)`` runs ``target`` ("module:function") in
``world`` new Python processes, ranks 0 to world - 1, joined by a
``FileStore`` in a temporary directory (no port to pick, nothing on the
network), over the backend of ``multihost.backend_for``: gloo on the CPU
and where ranks share a card, else NCCL.
Each process gets ``LOCAL_RANK`` (``parallel.local_device`` picks its card
from it) and one torch thread, and writes its output to a log;
every process has the same deadline and all are killed past it, so a hung
collective cannot hang the caller. A failure in any rank raises with the
tails of the logs. -> each rank's return value (pickled through a file).

``dryrun_multichip(n)``, the port's counterpart of
``__graft_entry__.dryrun_multichip``: n ranks (gloo processes on the CPU, or
ranks on the card with ``device="cuda"``) run one sharded train step of a
tiny DyYOLO (``TINY_CONFIG``, a copy of ``__graft_entry__.TINY_CONFIG``) at
64 px, batch 2n, over data x fsdp (fsdp 2 where n is even, as the JAX
dry-run), then a sharded detect of the same model; then, where n is even,
the JAX dry-run's second mesh, data x sp x ep (sp 2, ep 2 where n / 2 is
even): one train step of a fresh model placed on it and one spatial detect
(``make_detector(mesh=, spatial=True)``) of its weights; then the JAX
dry-run's third mesh, ``pp``: in each rank's own process, one pipelined
train step of a fresh model over S stages of the rank's device (S = 4 where
n >= 4, else 2; M = S microbatches; ``pp_loss``). The ranks must agree on
every loss.

    python -m uavdet_tpu_torch.parallel.dryrun --devices 4 [--device cuda]
"""

import argparse
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from .multihost import backend_for

TINY_CONFIG = (
    ("DyConv", 8, 3, 1), (16, 3, 2), ("B", 1), (32, 3, 2), ("B", 8),
    (64, 3, 2), ("B", 8), (128, 3, 2), ("B", 1), (64, 1, 1), (128, 3, 1),
    ("S",), (32, 1, 1), ("U",), (32, 1, 1), (64, 3, 1), ("S",),
    (16, 1, 1), ("U",), (16, 1, 1), (32, 3, 1), ("S",))

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def launch(target: str, world: int, args=(), device="cpu",
           timeout: float = 300) -> list:
    """Run ``target(*args)`` in ``world`` processes (see the module
    docstring); -> the ranks' return values in rank order."""
    tmp = tempfile.mkdtemp(prefix="uavdet_launch_")
    try:
        torch.save({"target": target, "args": tuple(args), "world": world,
                    "backend": backend_for(device, world)},
                   os.path.join(tmp, "spec.pt"))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_REPO, env.get("PYTHONPATH")) if p)
        env["OMP_NUM_THREADS"] = "1"
        procs, logs = [], []
        for rank in range(world):
            log = open(os.path.join(tmp, f"log{rank}.txt"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "uavdet_tpu_torch.parallel.dryrun",
                 "--worker", tmp, str(rank)],
                stdout=log, stderr=subprocess.STDOUT,
                env=dict(env, LOCAL_RANK=str(rank), RANK=str(rank),
                         WORLD_SIZE=str(world),
                         LOCAL_WORLD_SIZE=str(world))))
        deadline = time.monotonic() + timeout
        timed_out = False
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                timed_out = True
                break
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
        texts = []
        for rank in range(world):
            with open(os.path.join(tmp, f"log{rank}.txt")) as f:
                texts.append(f.read())
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if timed_out or failed:
            tails = "\n".join(f"--- rank {r} (exit {procs[r].returncode}):\n"
                              + texts[r][-6000:] for r in range(world))
            why = f"timed out after {timeout} s" if timed_out else \
                f"ranks {failed} failed"
            raise RuntimeError(f"launch {target} x {world}: {why}\n{tails}")
        return [torch.load(os.path.join(tmp, f"result{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _worker(tmp: str, rank: int) -> None:
    spec = torch.load(os.path.join(tmp, "spec.pt"), weights_only=False)
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), spec["world"])
    dist.init_process_group(spec["backend"], store=store, rank=rank,
                            world_size=spec["world"])
    try:
        module, name = spec["target"].split(":")
        result = getattr(importlib.import_module(module), name)(
            *spec["args"])
        torch.save(result, os.path.join(tmp, f"result{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def dryrun_rank(device: str = "cpu", size: int = 64) -> dict:
    """One rank of ``dryrun_multichip``."""
    import copy
    from types import SimpleNamespace
    from ..inference import make_detector
    from ..models.registry import DYYOLO
    from ..training import build_optimizer, init_state, make_train_step
    from ..utils.datatypes import BatchData
    from ..utils.seeding import seeded_model
    from .mesh import copy_full_weights, make_mesh, shard_model
    from .multihost import local_batch_rows, local_device, shard_host_batch
    from .pipeline import PipelinedModel, make_pp_trainer_step

    n = dist.get_world_size()
    n_fsdp = 2 if n % 2 == 0 else 1
    mesh = make_mesh(n // n_fsdp, n_fsdp, device_type=torch.device(device).type)
    dev = local_device(device)
    hp = SimpleNamespace(**dict(vars(DYYOLO), layer_config=TINY_CONFIG))
    model = seeded_model("DyYOLO", hp, 0, dev, dtype=torch.float32)
    plain = copy.deepcopy(model)
    placed = shard_model(model, mesh)
    state = init_state(placed, *build_optimizer(placed.parameters(), hp))
    step = make_train_step(placed, hp, size, mesh=mesh)

    batch = 2 * n
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(batch, size, size, 3)).astype(np.float32)
    boxes = np.tile(np.asarray([[0.3, 0.3, 0.6, 0.6]], np.float32),
                    (batch, 1, 1))
    mine = shard_host_batch(
        BatchData(*(torch.from_numpy(a) for a in (
            images, boxes, np.ones((batch, 1), bool)))),
        local_batch_rows(mesh, batch))
    metrics = step(state, BatchData(*(t.to(dev) for t in mine)))
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise FloatingPointError(f"non-finite loss {loss}")

    copy_full_weights(placed, plain)
    detect = make_detector(plain.eval(), hp, size,
                           compute_dtype=torch.float32, pre_nms_topk=64,
                           max_det=16, mesh=mesh)
    frames = (images * 255).astype(np.uint8)
    det = detect(frames)
    out = {"loss": loss, "mesh": {"data": n // n_fsdp, "fsdp": n_fsdp},
           "local_rows": len(mine.image), "detections": list(det.boxes.shape),
           "valid": int(det.valid.sum()), "step": state.step,
           "device": str(dev)}
    if n % 2 == 0:   # mesh 2: data x sp x ep
        n_ep = 2 if (n // 2) % 2 == 0 else 1
        mesh2 = make_mesh(n // (2 * n_ep), 1, 2, n_ep,
                          device_type=torch.device(device).type)
        model = seeded_model("DyYOLO", hp, 0, dev, dtype=torch.float32)
        plain = copy.deepcopy(model)
        placed = shard_model(model, mesh2)
        state = init_state(placed, *build_optimizer(placed.parameters(), hp))
        step = make_train_step(placed, hp, size, mesh=mesh2)
        mine = shard_host_batch(
            BatchData(*(torch.from_numpy(a) for a in (
                images, boxes, np.ones((batch, 1), bool)))),
            local_batch_rows(mesh2, batch))
        sp_loss = float(step(state, BatchData(*(t.to(dev) for t in mine)))
                        ["loss"])
        if not np.isfinite(sp_loss):
            raise FloatingPointError(f"non-finite sp x ep loss {sp_loss}")
        copy_full_weights(placed, plain)
        det = make_detector(plain.eval(), hp, size,
                            compute_dtype=torch.float32, pre_nms_topk=64,
                            max_det=16, mesh=mesh2, spatial=True)(frames)
        if not bool(torch.isfinite(det.scores).all()):
            raise FloatingPointError("non-finite spatial detect scores")
        out["sp_ep"] = {"loss": sp_loss,
                        "mesh": {"data": n // (2 * n_ep), "sp": 2,
                                 "ep": n_ep},
                        "local_rows": len(mine.image),
                        "valid": int(det.valid.sum())}
    # mesh 3: pp, one process over the stages on this rank's device
    n_pp = 4 if n >= 4 else 2
    pm = PipelinedModel.from_hparams(hp, n_pp, [dev] * n_pp)
    state = init_state(pm.model, *build_optimizer(pm.model.parameters(), hp))
    rows = batch // n_pp * n_pp
    pp_batch = BatchData(*(torch.from_numpy(a[:rows]).to(dev) for a in (
        images, boxes, np.ones((batch, 1), bool))))
    pp_loss = float(make_pp_trainer_step(pm, hp, size, n_pp)(
        state, pp_batch)["loss"])
    if not np.isfinite(pp_loss):
        raise FloatingPointError(f"non-finite pp loss {pp_loss}")
    out["pp_loss"] = pp_loss
    out["pp"] = {"stages": n_pp, "microbatches": n_pp, "rows": rows,
                 "ranges": pm.ranges}
    return out


def dryrun_multichip(n_devices: int, device: str = "cpu",
                     timeout: float = 600) -> dict:
    """The dry run over ``n_devices`` ranks (see the module docstring); ->
    rank 0's report. Raises where a rank fails or the ranks disagree."""
    reports = launch("uavdet_tpu_torch.parallel.dryrun:dryrun_rank",
                     n_devices, args=(device,), device=device,
                     timeout=timeout)
    for key in ("loss", "detections", "valid", "sp_ep", "pp_loss"):
        if len({json.dumps(r.get(key)) for r in reports}) != 1:
            raise RuntimeError(f"the ranks disagree on {key}: "
                               f"{[r[key] for r in reports]}")
    out = dict(reports[0])
    out["local_rows"] = [r["local_rows"] for r in reports]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Dry-run a sharded train step "
                                 "and a sharded detect over n ranks.")
    ap.add_argument("--devices", type=int, default=2)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--worker", nargs=2, metavar=("DIR", "RANK"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        _worker(args.worker[0], int(args.worker[1]))
        return 0
    print(json.dumps(dryrun_multichip(args.devices, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
