"""Batch inference CLI: image files -> detections JSON (+ annotated
frames), the port's ``scripts/detect.py``.

    python -m uavdet_tpu_torch.scripts.detect --images 'frames/*.jpg' \\
        --out dets.json [--ckpt best] [--score 0.25] [--draw annotated/] \\
        [--batch 16] [--device cpu]

Runs the params.yaml model (the ``CheckpointManager`` checkpoint named by
``--ckpt``, else the seeded initial weights of seed 0) through
``make_detector`` in the device's serving dtype (bf16 on the card, float32
on the CPU) over arbitrary image files. Frames are decoded by the frame
stage (nvJPEG on the card, PIL on the CPU) and resized to the detector's
size on the device with antialiasing, as PIL's ``BILINEAR`` does on the
JAX package's host; detections are reported in ORIGINAL-image pixel
coordinates, keyed by the path relative to the glob root. ``--draw``
writes annotated copies with cv2 and raises where cv2 is absent.

Under ``torch.distributed.run`` each rank takes the card ``LOCAL_RANK`` and
detects its rows of every chunk (``make_detector(mesh=)``); rank 0 writes
the JSON and the annotated copies.
"""

import argparse
import glob
import json
import os
import sys


def main(config=None, argv=None) -> int:
    ap = argparse.ArgumentParser(description="Detect UAVs in image files.")
    ap.add_argument("--images", required=True,
                    help="glob of image files (quote it)")
    ap.add_argument("--out", required=True, help="detections JSON path")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint name ('best'/'last'); default: the "
                         "seeded initial weights (pipeline smoke)")
    ap.add_argument("--score", type=float, default=0.25,
                    help="report detections with score >= this")
    ap.add_argument("--draw", default=None,
                    help="directory for annotated copies (cv2 boxes)")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    paths = sorted(glob.glob(args.images))
    if not paths:
        print(f"no files match {args.images!r}", file=sys.stderr)
        return 1
    # Key results by path RELATIVE to the glob root: Anti-UAV-style trees
    # name frames identically across sequence dirs (train/*/visible/000.jpg),
    # so basename keys would silently collide and drop detections.
    root = (os.path.commonpath(paths) if len(paths) > 1
            else os.path.dirname(paths[0]))
    if os.path.isfile(root):
        root = os.path.dirname(root)
    rel = {p: os.path.relpath(p, root) for p in paths}

    import numpy as np
    import torch

    from ..data.frames import decode, resize_frames
    from ..data.remote import read_bytes
    from ..evaluate import restored_model
    from ..inference import make_detector
    from ..models.registry import serving_dtype
    from ..parallel import is_writer, local_device, mesh_from_env

    if config is None:
        from ..utils.config import load_params
        config = load_params("params.yaml")
    hparams = config.model.hparams
    input_size = int(config.dataset.image_size[0])
    device = local_device(args.device)
    mesh = mesh_from_env(device)
    dtype = serving_dtype(device)
    model, name = restored_model(config, args.ckpt, device, dtype)
    if args.ckpt and name is None:
        print(f"no checkpoint {args.ckpt!r} in {config.train.checkpoint.dir}",
              file=sys.stderr)
        return 1
    detect = make_detector(model, hparams, input_size,
                           score_threshold=args.score, compute_dtype=dtype,
                           mesh=mesh)
    writer = is_writer()

    results = {}
    bs = args.batch
    for c0 in range(0, len(paths), bs):
        chunk = paths[c0:c0 + bs]
        frames = decode([read_bytes(p) for p in chunk], device)
        x = resize_frames(frames, input_size, antialias=True)
        dets = detect(x.permute(0, 2, 3, 1).to(torch.uint8))
        boxes = dets.boxes.float().cpu().numpy()
        scores = dets.scores.float().cpu().numpy()
        valid = dets.valid.cpu().numpy()
        for i, path in enumerate(chunk):
            h0, w0 = frames[i].shape[:2]
            sx, sy = w0 / input_size, h0 / input_size
            keep = valid[i] & (scores[i] >= args.score)
            bx = boxes[i][keep] * np.asarray([sx, sy, sx, sy])
            results[rel[path]] = {
                "boxes_xyxy": np.round(bx, 2).tolist(),
                "scores": np.round(scores[i][keep], 4).tolist(),
            }
            if args.draw and writer:
                from ..utils.viz import draw_bbox, write_rgb
                out_path = os.path.join(args.draw, rel[path])
                os.makedirs(os.path.dirname(out_path) or args.draw,
                            exist_ok=True)
                img = frames[i].cpu().numpy().copy()
                for b, s in zip(bx, scores[i][keep]):
                    img = draw_bbox(img, b, label=f"uav {s:.2f}")
                write_rgb(out_path, img)
        print(f"{min(c0 + bs, len(paths))}/{len(paths)} frames")

    if not writer:
        return 0
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    n_det = sum(len(v["scores"]) for v in results.values())
    print(f"wrote {args.out}: {n_det} detections over {len(results)} frames")
    return 0


if __name__ == "__main__":
    sys.exit(main())
