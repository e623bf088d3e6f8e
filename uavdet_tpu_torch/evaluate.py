"""Evaluation entry: detector over a split's manifest -> mAP + fps, the
port's ``evaluate.py``.

    python -m uavdet_tpu_torch.evaluate [--split val|test] [--ckpt last|best]
        [--limit N] [--batch 16] [--dump dets.json] [--device cpu]

Reads params.yaml for everything else. Restores the ``CheckpointManager``
checkpoint (``state.pt``; the seeded initial weights of seed 0 when there
is none, with a warning), serves the model through ``make_detector``
(score threshold 0.001, IoU 0.5, 300 kept) in the device's serving dtype
(bf16 on the card, where a DyYOLO runs kernels A, B and C; float32 on the
CPU), over the split's frames from a ``DataPipeline`` in order, and prints
one JSON line: torchmetrics-compatible mAP (cxcywh, IoU 0.5:0.95,
max_det 300), ``images`` and ``fps`` (images over the seconds spent in the
detector, its results on the host included).

Under ``torch.distributed.run`` each rank takes the card ``LOCAL_RANK`` and
detects its rows of every batch (the sharded detect of
``make_detector(mesh=)``); every rank holds the gathered detections and
rank 0 prints and writes ``--dump``.
"""

import argparse
import json
import time

import torch


def evaluate_batches(detect, batches, input_size: int,
                     dump: bool = False) -> tuple:
    """The evaluation loop of the JAX package's ``evaluate.py:81-111``:
    -> (metric dict with ``images`` and ``fps``, per-image detections as
    lists when ``dump``, else [])."""
    from .ops.map import MeanAveragePrecision, add_detections
    metric = MeanAveragePrecision()
    n_img, t_total = 0, 0.0
    dumped = []
    for batch in batches:
        t0 = time.perf_counter()
        det = detect(batch.image)
        det.boxes.cpu()   # waits for the device
        t_total += time.perf_counter() - t0
        for row in add_detections(metric, det, batch.boxes, batch.box_mask,
                                  input_size):
            if dump:
                dumped.append({k: v.tolist() for k, v in row.items()})
            n_img += 1
    out = metric.compute()
    out["images"] = n_img
    out["fps"] = round(n_img / t_total, 1) if t_total else None
    return out, dumped


def restored_model(config, ckpt: str | None, device, dtype: torch.dtype):
    """The params.yaml model as the entry points serve it: seed 0's initial
    weights in float32 (the training state's), the checkpoint ``ckpt`` of
    ``config.train.checkpoint`` restored into them where it exists
    ('best' is the best one ``meta.json`` records), then cast to ``dtype``,
    in eval mode. -> (model, the name restored or None)."""
    from .training import CheckpointManager, build_optimizer, init_state
    from .utils.seeding import seeded_model

    hparams = config.model.hparams
    model = seeded_model(config.model.name, hparams, 0, device,
                         dtype=torch.float32)
    restored = None
    if ckpt:
        ck = config.train.checkpoint
        mgr = CheckpointManager(ck.dir, monitor=ck.monitor, mode=ck.mode)
        name = mgr.best_path if ckpt == "best" and mgr.best_path else ckpt
        if mgr.has_checkpoint(name):
            state = init_state(model, *build_optimizer(model.parameters(),
                                                       hparams))
            mgr.restore(state, name)
            restored = name
    return model.to(dtype).eval(), restored


def main(config=None, argv=None) -> dict:
    """-> the printed metric dict. ``config`` is a ``utils.config.Config``
    (params.yaml is read when it is None)."""
    ap = argparse.ArgumentParser(description="Evaluate a detector of the "
                                 "port on a split's manifest.")
    ap.add_argument("--split", default="val", choices=["val", "test"])
    ap.add_argument("--ckpt", default="last")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--dump", default=None,
                    help="write per-image detections (xyxy px + scores) "
                         "to this JSON path — the parity-protocol artifact")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from .data import DataPipeline, load_manifest
    from .data.remote import make_filesystem
    from .inference import make_detector
    from .models.registry import serving_dtype
    from .parallel import is_writer, local_device, mesh_from_env

    if config is None:
        from .utils.config import load_params
        config = load_params("params.yaml")
    hparams = config.model.hparams
    input_size = int(config.dataset.image_size[0])
    device = local_device(args.device)
    mesh = mesh_from_env(device)
    dtype = serving_dtype(device)
    model, name = restored_model(config, args.ckpt, device, dtype)
    if name:
        print(f"Restored checkpoint '{name}'")
    else:
        print(f"WARNING: no checkpoint '{args.ckpt}', evaluating random init")

    ds = config.dataset
    records = load_manifest(ds.val_loader_path if args.split == "val"
                            else ds.test_loader_path)
    if args.limit:
        records = records[:args.limit]
    pipe = DataPipeline(records, input_size=input_size,
                        batch_size=args.batch, train=False, shuffle=False,
                        drop_last=False,
                        fs=make_filesystem(ds.root_dir,
                                           bool(ds.get("remote", False))),
                        workers=int(ds.get("workers", 1) or 1),
                        device=device)
    detect = make_detector(model, hparams, input_size, compute_dtype=dtype,
                           mesh=mesh)
    out, dumped = evaluate_batches(detect, pipe, input_size,
                                   dump=args.dump is not None)
    if not is_writer():
        return out
    if args.dump is not None:
        with open(args.dump, "w") as f:
            json.dump({"images": dumped}, f)
    print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                      for k, v in out.items()}))
    return out


if __name__ == "__main__":
    main()
