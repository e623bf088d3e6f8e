"""Export the params.yaml detector to a serving artifact: the port's
``scripts/export_detector.py``.

    python -m uavdet_tpu_torch.scripts.export_detector --out detector.pt2
        [--ckpt best|last] [--batch 16] [--dual] [--device cuda]

Builds the params.yaml model in bf16, with the ``CheckpointManager``
checkpoint named by ``--ckpt`` restored as ``evaluate`` restores it (the
seeded initial weights of seed 0 without ``--ckpt``), and serializes the
whole detector with ``export.export_detector``: the weights travel in the
artifact, which ``export.load_detector`` serves. ``--device`` (the card
unless named) is the port's counterpart of the JAX script's ``--platform``:
a card artifact runs the kernels, a CPU one their plain versions.
"""

import argparse
import sys

import torch


def main(config=None, argv=None) -> int:
    """``config`` is a ``utils.config.Config`` (params.yaml is read when it
    is None)."""
    ap = argparse.ArgumentParser(description="Export the params.yaml "
                                 "detector of the port to a torch.export "
                                 "artifact.")
    ap.add_argument("--out", required=True)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint name ('best'/'last'); default: the "
                         "seeded initial weights")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--dual", action="store_true",
                    help="native-size RGB + infrared dual-stream entry")
    ap.add_argument("--device", default="cuda",
                    help="torch device the artifact is made for (default: "
                         "the card)")
    args = ap.parse_args(argv)

    from ..evaluate import restored_model
    from ..export import export_detector

    if config is None:
        from ..utils.config import load_params
        config = load_params("params.yaml")
    hparams = config.model.hparams
    input_size = int(config.dataset.image_size[0])
    model, name = restored_model(config, args.ckpt, torch.device(args.device),
                                 torch.bfloat16)
    if args.ckpt and name is None:
        print(f"no checkpoint {args.ckpt!r} in {config.train.checkpoint.dir}",
              file=sys.stderr)
        return 1
    blob = export_detector(model, hparams, input_size, args.batch,
                           dual=args.dual)
    with open(args.out, "wb") as f:
        f.write(blob)
    print(f"wrote {args.out} ({len(blob) / 1e6:.1f} MB, batch={args.batch}, "
          f"dual={args.dual})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
