"""Stage 1: build dataset manifests, the port's ``prepare_dataloader.py``.

    python -m uavdet_tpu_torch.prepare_dataloader

Reads params.yaml (no other arguments, the same keys as the JAX package's
stage), scans the Anti-UAV-RGBT tree for the train/val/test splits and
writes one JSON manifest per split, byte for byte the JAX stage's. This
stage reads files only and uses no device.
"""

import os

from .data import build_index, save_manifest
from .data.remote import make_filesystem
from .utils.seeding import seed_everything


def main(config=None, argv=None) -> dict:
    """-> {split: number of frames}. ``config`` is a ``utils.config.Config``
    (params.yaml is read when it is None)."""
    if argv:
        raise SystemExit(f"prepare_dataloader takes no arguments, got {argv}")
    if config is None:
        from .utils.config import load_params
        config = load_params("params.yaml")
    seed = int(config.train.seed or 11)
    seed_everything(seed)

    ds = config.dataset
    fs = make_filesystem(ds.root_dir, bool(ds.get("remote", False)))

    counts = {}
    for split, out_path in (("train", ds.train_loader_path),
                            ("val", ds.val_loader_path),
                            ("test", ds.test_loader_path)):
        records = build_index(os.path.join(ds.root_dir, split),
                              seed=seed, fs=fs)
        save_manifest(records, out_path)
        counts[split] = len(records)
        print(f"Created {split} manifest ({len(records)} frames) "
              f"-> {out_path}")
    return counts


if __name__ == "__main__":
    import sys
    main(argv=sys.argv[1:])
