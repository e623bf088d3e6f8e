"""Anti-UAV-RGBT dataset index builder.

Replaces the reference's ``AntiUAVDataset.__load_data``
(dataset/AntiUAVDataset.py:93-139) and the joblib-pickled-DataLoader
hand-off (prepare_dataloader.py:67-69; 142/58/80 MB artifacts) with a
lightweight serialized manifest: stage 1 scans the dataset tree once and
emits JSON; stage 2 (and any number of trainers) consume it.

Directory layout scanned (reference :107-123):
    <root>/<split>/<seq>/{visible,infrared}/<cam>-%04d.jpg
    <root>/<split>/<seq>/{visible,infrared}.json   (gt_rect xywh, exist)
    <root>/label_new/<seq>.json                    (attribute tags)

Semantics preserved:
  * every sequence contributes BOTH modality streams as separate samples,
  * frames filtered to exist==1 and positive width/height (reference
    :129-131),
  * boxes converted xywh → xyxy (reference :134),
  * deterministic shuffle by seed (reference :137).

The port's own copy of ``uavdet_tpu/data/antiuav.py`` (that package imports
JAX); ``tests/test_torch_data.py`` holds its manifests byte for byte equal
to the original's.
"""

import json
import os
from typing import List, Optional

import numpy as np


def _load_json(path, fs=None):
    if fs is not None:
        return fs.load_json(path)
    with open(path) as f:
        return json.load(f)


def _list_dir(path, fs=None):
    if fs is not None:
        return fs.list_dir(path)
    return sorted(os.listdir(path))


def load_attributes(attr_dir: str, fs=None) -> dict:
    """label_new/<seq>.json → {seq: attributes} (reference
    dataset/_helper.py:45-82)."""
    out = {}
    if not (fs.exists(attr_dir) if fs else os.path.isdir(attr_dir)):
        return out
    for name in _list_dir(attr_dir, fs):
        out[name.split(".")[0]] = _load_json(
            os.path.join(attr_dir, name), fs)
    return out


def build_index(root_dir: str, seed: int = 11, fs=None) -> List[dict]:
    """Scan one split directory into a list of frame records.

    Each record: {img_path, cam_type, bbox (xyxy pixels), attribute}.
    """
    split = os.path.basename(root_dir)
    attr_dir = os.path.join(os.path.dirname(root_dir), "label_new")
    attrs = load_attributes(attr_dir, fs)

    records = []
    for seq in _list_dir(root_dir, fs):
        seq_dir = os.path.join(root_dir, seq)
        if not (fs.isdir(seq_dir) if fs else os.path.isdir(seq_dir)):
            continue
        for cam in ("visible", "infrared"):
            gt_path = os.path.join(seq_dir, f"{cam}.json")
            gt = _load_json(gt_path, fs)
            n = len(gt["gt_rect"])
            exist = gt.get("exist", [1] * n)
            for i in range(n):
                x, y, w, h = gt["gt_rect"][i]
                if not exist[i] or w <= 0 or h <= 0:
                    continue
                records.append(dict(
                    img_path=os.path.join(
                        seq_dir, cam, f"{cam}-{str(i).zfill(4)}.jpg"),
                    cam_type=cam,
                    bbox=[float(x), float(y), float(x + w), float(y + h)],
                    attribute=attrs.get(seq, attrs.get(split, {})),
                ))

    rng = np.random.default_rng(seed)
    order = rng.permutation(len(records))
    return [records[i] for i in order]


def save_manifest(records: List[dict], path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump({"version": 1, "records": records}, f)


def load_manifest(path: str) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    return data["records"]
