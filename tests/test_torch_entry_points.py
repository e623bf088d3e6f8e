"""The port's entry points (``python -m uavdet_tpu_torch.prepare_dataloader``,
``.train``, ``.evaluate``, ``.scripts.detect``) end to end on the CPU, and
its evaluation loop against the JAX package's.

The subprocess runs use the 64 px ``TINY`` configuration of
tests/test_entry_points.py over a synthetic tree written by the port's
writer, with ``--device cpu`` and one torch thread. The evaluation loop of
``uavdet_tpu_torch.evaluate`` is held against ``evaluate.py:81-111`` run
here from the JAX package's modules (its ``make_detector`` and
``MeanAveragePrecision``), on the same frames with the same weights (the
port's seeded model taken to flax by ``utils.torch_import``), both in f32:
the mAP dict must match to 1e-6, the dump's valid counts must be equal and
its scores agree to rtol 1e-4 (the convolutions associate differently).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml
import jax.numpy as jnp

from tests.test_entry_points import TINY, _PP
from tests.test_torch_train_step import one_torch_thread  # noqa: F401
from uavdet_tpu.inference import make_detector as jax_make_detector
from uavdet_tpu.models import build_model as jax_build_model
from uavdet_tpu.ops.map import MeanAveragePrecision as JaxMAP
from uavdet_tpu.utils.config import Config as JaxConfig
from uavdet_tpu.utils.torch_import import import_interpreter_state_dict
from uavdet_tpu_torch.data import (DataPipeline, build_index,
                                   make_synthetic_dataset)
from uavdet_tpu_torch.evaluate import evaluate_batches
from uavdet_tpu_torch.inference import make_detector
from uavdet_tpu_torch.utils.config import Config
from uavdet_tpu_torch.utils.seeding import seeded_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64

HPARAMS = {
    "anchors": [[[40, 30], [60, 46], [54, 36]],
                [[18, 14], [24, 18], [30, 12]],
                [[6, 5], [10, 6], [13, 8]]],
    "head_scales": [16, 8, 4], "lr": 0.001, "lr_scheduler": False,
    "loss_balancing": {"obj_scales_w": [0.5, 1.0, 2.0], "bbox_w": 4.0,
                       "objectness_w": 1.0, "no_obj_w": 4.0},
    "bbox_loss_fn": "mse", "attn_temperature": 30.0,
    "optim": {"name": "SGD", "momentum": 0.78},
    "layer_config": TINY}


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    wd = tmp_path_factory.mktemp("torch_e2e")
    make_synthetic_dataset(str(wd / "data" / "Anti-UAV-RGBT"), n_seq=1,
                           n_frames=6, img_size=128, device="cpu")
    params = {
        "dataset": {
            "root_dir": "data/Anti-UAV-RGBT",
            "train_loader_path": "data/train_manifest.json",
            "val_loader_path": "data/val_manifest.json",
            "test_loader_path": "data/test_manifest.json",
            "batch_size": 2, "remote": False, "image_size": [SIZE, SIZE],
            "workers": 2, "mosaic": False, "format": "yolo"},
        "train": {
            "seed": 211,
            "trainer": {
                "epochs": 1, "input_size": [3, SIZE, SIZE],
                "profiler": None, "grad_batches": 1, "train_batches": 2,
                "val_batches": 2, "val_check_interval": 1.0,
                "accelerator": "cpu", "devices": 1, "precision": 32,
                "grad_clip_val": None, "eval_ap": True},
            "checkpoint": {"dir": "logs/checkpoints",
                           "monitor": "val_loss", "mode": "min"}},
        "model": {"name": "DyYOLO", "hparams": HPARAMS}}
    with open(wd / "params.yaml", "w") as f:
        yaml.safe_dump(params, f)
    return wd


def _run(module, wd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + _PP)
    return subprocess.run(
        [sys.executable, "-m", f"uavdet_tpu_torch.{module}", *args],
        cwd=wd, env=env, capture_output=True, text=True, timeout=300)


def test_stage1_prepare(workdir):
    r = _run("prepare_dataloader", workdir)
    assert r.returncode == 0, r.stderr[-2000:]
    for split in ("train", "val", "test"):
        recs = json.loads((workdir / "data" / f"{split}_manifest.json")
                          .read_text())["records"]
        assert len(recs) > 0


def test_stage2_train(workdir):
    """The metrics.json and plots contract (dvc.yaml), best and last
    checkpoints."""
    r = _run("train", workdir, "--device", "cpu")
    assert r.returncode == 0, r.stderr[-2000:]
    metrics = json.loads((workdir / "dvclive" / "metrics.json").read_text())
    assert "train" in metrics and "val" in metrics
    assert metrics["train"]["loss"] > 0
    assert "step" in metrics and metrics["epoch"] == 0
    for split in ("train", "val"):
        for m in ("loss", "bbox_loss", "obj_loss"):
            assert (workdir / "dvclive" / "plots" / "metrics" / split /
                    f"{m}.tsv").exists()
    names = os.listdir(workdir / "logs" / "checkpoints")
    assert "last" in names
    assert any(n.startswith("best-") for n in names)


def test_stage3_evaluate(workdir):
    r = _run("evaluate", workdir, "--split", "val", "--ckpt", "best",
             "--batch", "2", "--limit", "4", "--device", "cpu",
             "--dump", "dump.json")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Restored checkpoint 'best-" in r.stdout
    out = json.loads(r.stdout.strip().splitlines()[-1])
    for key in ("map", "map_50", "images", "fps"):
        assert key in out
    dump = json.loads((workdir / "dump.json").read_text())["images"]
    assert out["images"] == len(dump) > 0
    assert set(dump[0]) == {"boxes_xyxy", "scores", "gt_xyxy"}


def test_detect_cli(workdir):
    """Detections keyed by the path relative to the glob root (two sequence
    dirs with identical frame names: basename keys would collide), in
    original pixels, and annotated copies that mirror the tree."""
    import shutil
    src = sorted((workdir / "data" / "Anti-UAV-RGBT" / "train")
                 .glob("*/visible/*.jpg"))
    for seq in ("seqA", "seqB"):
        d = workdir / "frames" / seq / "visible"
        os.makedirs(d, exist_ok=True)
        for p in src:
            shutil.copy(p, d / p.name)
    r = _run("scripts.detect", workdir, "--images",
             str(workdir / "frames" / "*" / "visible" / "*.jpg"),
             "--out", "dets.json", "--score", "0.0", "--batch", "3",
             "--ckpt", "last", "--device", "cpu", "--draw", "annotated")
    assert r.returncode == 0, r.stderr[-2000:]
    dets = json.loads((workdir / "dets.json").read_text())
    assert len(dets) == 2 * len(src)
    assert all(k.startswith(("seqA", "seqB")) for k in dets)
    boxes = np.concatenate([np.asarray(v["boxes_xyxy"]).reshape(-1, 4)
                            for v in dets.values()])
    assert len(boxes) > 0 and all("scores" in v for v in dets.values())
    # original pixels: the 128 px frames, not the detector's 64 px grid
    assert boxes.max() > SIZE
    ann = [os.path.join(dp, f)
           for dp, _, fs in os.walk(workdir / "annotated") for f in fs]
    assert len(ann) == 2 * len(src)


def test_draw_without_cv2_raises(monkeypatch):
    """On a host without OpenCV (the card's), --draw fails with a message
    that says so."""
    from uavdet_tpu_torch.utils.viz import draw_bbox
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="OpenCV"):
        draw_bbox(np.zeros((8, 8, 3), np.uint8), [1, 1, 4, 4])


def test_evaluate_loop_matches_jax(tmp_path):
    """The port's evaluation loop against the JAX package's on the same
    frames and weights, f32 on both sides."""
    root = make_synthetic_dataset(str(tmp_path / "t"), splits=("val",),
                                  n_seq=2, n_frames=6, img_size=96,
                                  device="cpu")
    records = build_index(os.path.join(root, "val"))
    batches = list(DataPipeline(records, SIZE, 4, train=False,
                                shuffle=False, drop_last=False,
                                device="cpu"))
    port = seeded_model("DyYOLO", Config(HPARAMS), 3, "cpu",
                        dtype=torch.float32)
    got, got_dump = evaluate_batches(
        make_detector(port, Config(HPARAMS), SIZE,
                      compute_dtype=torch.float32), batches, SIZE, dump=True)

    # evaluate.py:81-111 with the JAX package's detector and metric
    params, stats = import_interpreter_state_dict(
        {k: v.numpy() for k, v in port.state_dict().items()}, TINY)
    variables = {"params": params, "batch_stats": stats}
    jm = jax_build_model("DyYOLO", JaxConfig(HPARAMS), dtype=jnp.float32)
    detect = jax_make_detector(jm, JaxConfig(HPARAMS), SIZE,
                               compute_dtype=jnp.float32)
    metric = JaxMAP()
    want_dump = []
    for batch in batches:
        det = detect(variables, jnp.asarray(batch.image.numpy()))
        boxes, scores = np.asarray(det.boxes), np.asarray(det.scores)
        valid = np.asarray(det.valid)
        gt = batch.boxes.numpy() * SIZE
        gt_mask = batch.box_mask.numpy()
        for i in range(boxes.shape[0]):
            b = boxes[i][valid[i]]
            cxcywh = np.stack([(b[:, 0] + b[:, 2]) / 2,
                               (b[:, 1] + b[:, 3]) / 2,
                               b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], -1)
            g = gt[i][gt_mask[i]]
            g_cxcywh = np.stack([(g[:, 0] + g[:, 2]) / 2,
                                 (g[:, 1] + g[:, 3]) / 2,
                                 g[:, 2] - g[:, 0], g[:, 3] - g[:, 1]], -1)
            metric.update(cxcywh, scores[i][valid[i]], g_cxcywh)
            want_dump.append(scores[i][valid[i]])
    want = metric.compute()

    assert got["images"] == len(want_dump) == len(records) > 0
    assert got["map_50"] > 0   # a non-trivial comparison
    for key, value in want.items():
        assert got[key] == pytest.approx(value, abs=1e-6), key
    for row, scores in zip(got_dump, want_dump):
        assert len(row["scores"]) == len(scores)
        np.testing.assert_allclose(row["scores"], scores, rtol=1e-4)
