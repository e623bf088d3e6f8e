"""Synthetic Anti-UAV-RGBT mini-tree generator for tests and smoke runs.

The port's own copy of ``uavdet_tpu/data/synthetic.py``: the same directory
layout (per-sequence visible/infrared frame dirs + gt JSONs + label_new
attributes), the same RNG draws in the same order and the same JSON.
Frames contain a bright rectangle at the GT box so a trained detector has
signal.

``device="cpu"`` writes the frames with PIL at its default quality, so the
tree is the JAX writer's byte for byte. On the card, where PIL is absent,
they are encoded by nvJPEG (``data/jpeg.py``) at ``CARD_QUALITY`` with
4:4:4 sampling: other bytes, the same drawn arrays.
"""

import json
import os
from typing import Iterator

import numpy as np
import torch

CARD_QUALITY = 95


def synthetic_frames(root: str, splits=("train", "val", "test"),
                     n_seq: int = 2, n_frames: int = 6, img_size: int = 160,
                     seed: int = 0) -> Iterator[tuple]:
    """The tree as the writer makes it, in its order: ``("frame", path,
    uint8 (S, S, 3) array)`` and ``("json", path, object)`` items."""
    rng = np.random.default_rng(seed)
    for split in splits:
        for s in range(n_seq):
            seq = f"{split}_seq{s:02d}"
            seq_dir = os.path.join(root, split, seq)
            yield ("json", os.path.join(root, "label_new", f"{seq}.json"),
                   {"TS": "small", "LR": 1})

            for cam in ("visible", "infrared"):
                cam_dir = os.path.join(seq_dir, cam)
                gt_rect, exist = [], []
                for i in range(n_frames):
                    present = int(rng.uniform() > 0.2)
                    w = int(rng.integers(12, img_size // 3))
                    h = int(rng.integers(12, img_size // 3))
                    x = int(rng.integers(0, img_size - w))
                    y = int(rng.integers(0, img_size - h))
                    gt_rect.append([x, y, w, h] if present else [0, 0, 0, 0])
                    exist.append(present)

                    img = rng.integers(
                        0, 80, size=(img_size, img_size, 3),
                        dtype=np.uint8)
                    if present:
                        img[y:y + h, x:x + w] = (
                            np.asarray([255, 240, 220], np.uint8)
                            if cam == "visible"
                            else np.asarray([250, 250, 250], np.uint8))
                    yield ("frame", os.path.join(
                        cam_dir, f"{cam}-{str(i).zfill(4)}.jpg"), img)

                yield ("json", os.path.join(seq_dir, f"{cam}.json"),
                       {"gt_rect": gt_rect, "exist": exist})


def _writer(device):
    device = torch.device(device)
    if device.type == "cpu":
        from PIL import Image

        def write(path, img):
            Image.fromarray(img).save(path)
        return write
    if device.type == "cuda":
        from .jpeg import encode

        def write(path, img):
            data = encode(torch.from_numpy(img).to(device), CARD_QUALITY)
            with open(path, "wb") as f:
                f.write(data)
        return write
    raise ValueError(f"no JPEG writer for device {device}")


def make_synthetic_dataset(root: str, splits=("train", "val", "test"),
                           n_seq: int = 2, n_frames: int = 6,
                           img_size: int = 160, seed: int = 0,
                           device="cuda") -> str:
    write = _writer(device)
    for kind, path, obj in synthetic_frames(root, splits, n_seq, n_frames,
                                            img_size, seed):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if kind == "frame":
            write(path, obj)
        else:
            with open(path, "w") as f:
                json.dump(obj, f)
    return root
