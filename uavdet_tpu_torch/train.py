"""Stage 2: train, the port's ``train.py``.

    python -m uavdet_tpu_torch.train [--resume] [--device cpu]

Reads params.yaml (the same keys as the JAX package's stage), loads the
stage-1 manifests into two ``DataPipeline``s (train: shuffled, the
affine; val: in order, resize only), dispatches the model by
``model.name`` and trains it with ``training.Trainer``: DVCLive-format
metrics (``dvclive/metrics.json`` + plots tsv) and best/last checkpoints
under ``train.checkpoint.dir``. ``--resume`` continues from the ``last``
checkpoint. Everything runs on the card unless ``--device cpu``.

Under ``torch.distributed.run`` (with ``train.trainer.devices`` the number
of processes) each rank takes the card ``LOCAL_RANK`` and the trainer its
place on the data x fsdp mesh; rank 0 writes the checkpoints and metrics
and prints the result:

    python -m torch.distributed.run --nproc_per_node 2 \
        -m uavdet_tpu_torch.train [--device cpu]
"""

import argparse

from .data import DataPipeline, load_manifest
from .data.remote import make_filesystem
from .parallel import is_writer, local_device
from .training import MetricsWriter, Trainer
from .utils.seeding import seed_everything


def build_pipelines(config, device) -> tuple:
    """The train and val pipelines of the JAX stage (``train.py:40-51``)."""
    ds = config.dataset
    fs = make_filesystem(ds.root_dir, bool(ds.get("remote", False)))
    input_size = int(ds.image_size[0])
    seed = int(config.train.seed or 11)
    workers = int(ds.get("workers", 1) or 1)
    fmt = str(ds.get("format", "yolo"))
    train_pipe = DataPipeline(
        load_manifest(ds.train_loader_path), input_size=input_size,
        batch_size=int(ds.batch_size), train=True, seed=seed,
        mosaic=bool(ds.get("mosaic", False)), fs=fs, workers=workers,
        fmt=fmt, device=device)
    print("Train manifest loaded...")
    val_pipe = DataPipeline(
        load_manifest(ds.val_loader_path), input_size=input_size,
        batch_size=int(ds.batch_size), train=False, seed=seed, fs=fs,
        workers=workers, fmt=fmt, device=device)
    print("Validation manifest loaded...")
    return train_pipe, val_pipe


def main(config=None, argv=None) -> dict:
    """-> the final metrics of ``Trainer.fit``. ``config`` is a
    ``utils.config.Config`` (params.yaml is read when it is None)."""
    ap = argparse.ArgumentParser(description="Train a detector of the port.")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the last checkpoint")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if config is None:
        from .utils.config import load_params
        config = load_params("params.yaml")
    if config.train.seed:
        seed_everything(int(config.train.seed))

    device = local_device(args.device)
    train_pipe, val_pipe = build_pipelines(config, device)
    trainer = Trainer(config, train_pipe, val_pipe,
                      metrics=MetricsWriter("dvclive"), device=device)
    final = trainer.fit(resume=args.resume)
    if is_writer():
        print({k: round(v, 5) if isinstance(v, float) else v
               for k, v in final.items()})
    return final


if __name__ == "__main__":
    main()
