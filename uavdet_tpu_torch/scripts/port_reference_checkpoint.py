"""Port a reference Lightning ``.ckpt`` to a checkpoint of the port: its
``scripts/port_reference_checkpoint.py``.

    python -m uavdet_tpu_torch.scripts.port_reference_checkpoint \\
        <ref.ckpt> <out_dir> [--params params.yaml]

Imports the state_dict (``utils/torch_import.py``: checked key by key and
shape by shape against the params.yaml model) and writes ``out_dir/last``
in the ``CheckpointManager`` format: the imported weights, a fresh
optimizer state and step 0. With ``out_dir`` the ``train.checkpoint.dir``
of params.yaml, ``python -m uavdet_tpu_torch.evaluate --ckpt last`` and
``python -m uavdet_tpu_torch.scripts.export_detector --ckpt last`` restore
it.
"""

import argparse
import os
import sys

import torch


def main(config=None, argv=None) -> int:
    """``config`` is a ``utils.config.Config`` (``--params`` is read when it
    is None)."""
    ap = argparse.ArgumentParser(description="Port a reference Lightning "
                                 "checkpoint to the port's checkpoint "
                                 "format.")
    ap.add_argument("ckpt")
    ap.add_argument("out_dir")
    ap.add_argument("--params", default="params.yaml")
    args = ap.parse_args(argv)

    from ..models import build_model
    from ..training import CheckpointManager, build_optimizer, init_state
    from ..utils.torch_import import load_lightning_checkpoint

    if config is None:
        from ..utils.config import load_params
        config = load_params(args.params)
    hparams = config.model.hparams
    if config.model.name not in ("DyYOLO", "baseline"):
        raise SystemExit(f"reference checkpoints map onto DyYOLO and "
                         f"baseline only, not {config.model.name!r}")
    sd = load_lightning_checkpoint(args.ckpt, hparams.layer_config,
                                   len(hparams.anchors[0]))
    model = build_model(config.model.name, hparams, dtype=torch.float32,
                        device="cpu")
    model.load_state_dict(sd, strict=True)
    state = init_state(model, *build_optimizer(model.parameters(), hparams))
    mgr = CheckpointManager(args.out_dir)
    mgr._save(state, os.path.join(mgr.ckpt_dir, "last"))
    n = sum(p.numel() for p in model.parameters())
    print(f"ported {n / 1e6:.1f}M params -> {args.out_dir}/last")
    return 0


if __name__ == "__main__":
    sys.exit(main())
