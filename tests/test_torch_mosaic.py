"""The port's mosaic pixel path against OpenCV and the JAX package, on the
CPU.

* ``ops.resize.lanczos4_resize`` against ``cv2.resize(INTER_LANCZOS4)`` on
  uint8 frames, three-channel and grey, over downscales (the cameras'
  1920 x 1080 and 640 x 512 into a 320 px quadrant), upscales, odd sizes,
  sizes off by one, one-pixel frames and the identity: bitwise.
* ``data.mosaic.create_mosaic_4_img`` against the JAX one, with degenerate
  boxes, fewer than 4 placed, none placed and a grey source: canvas and
  boxes bitwise.
* ``DataPipeline(mosaic=True, train=True)`` against the JAX
  ``DataPipeline(mosaic=True)`` over a synthetic tree, ``workers`` 1 and 2
  (the shared RNG and the per-position ones): membership and masks equal,
  boxes within 1e-4 px, pixels within one unit in 255 and 0.2 on average
  (tests/test_torch_data.py's bounds: the canvases are equal, the affine is
  cv2's fixed-point ``warpAffine`` against torch's float ``grid_sample``).
  The JAX side runs without its native loader, on its PIL + cv2 path. A
  validation pipeline ignores ``mosaic``, as the JAX one does.
* ``train.main --device cpu`` with ``dataset.mosaic: true`` trains.
"""

import os

import cv2
import numpy as np
import pytest
import torch

import uavdet_tpu.data.native as jax_native
from tests.test_torch_data import _assert_same_batches
from tests.test_torch_entry_points import HPARAMS
from tests.test_torch_train_step import one_torch_thread  # noqa: F401
from uavdet_tpu.data import DataPipeline as JaxPipeline
from uavdet_tpu.data import make_synthetic_dataset as jax_synthetic
from uavdet_tpu.data.mosaic import create_mosaic_4_img as jax_mosaic
from uavdet_tpu_torch.data import DataPipeline, build_index
from uavdet_tpu_torch.data.mosaic import create_mosaic_4_img
from uavdet_tpu_torch.ops.resize import lanczos4_resize

SIZE = 64

RESIZES = [
    ((1080, 1920), (320, 320)),   # the visible camera into a quadrant
    ((512, 640), (320, 320)),     # the infrared camera
    ((96, 96), (32, 32)),         # the synthetic tree's frames at 64 px
    ((30, 40), (77, 91)),         # upscales
    ((7, 5), (16, 16)),
    ((33, 33), (32, 32)),         # off by one
    ((32, 32), (33, 31)),
    ((101, 67), (50, 34)),        # odd
    ((1, 1), (5, 5)),             # one pixel
    ((3, 200), (9, 17)),
    ((64, 48), (64, 48)),         # the identity
]


@pytest.mark.parametrize("grey", [False, True], ids=["rgb", "grey"])
@pytest.mark.parametrize("src,dst", RESIZES,
                         ids=[f"{s[0]}x{s[1]}-{d[0]}x{d[1]}"
                              for s, d in RESIZES])
def test_lanczos4_is_cv2s(src, dst, grey):
    rng = np.random.default_rng(src[0] * 7 + dst[1])
    img = rng.integers(0, 256, src if grey else (*src, 3), dtype=np.uint8)
    # a hard edge as well as noise: the kernel's overshoot saturates
    img[: src[0] // 2] = 255
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LANCZOS4)
    got = lanczos4_resize(torch.from_numpy(img), *dst)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_lanczos4_batches_frames():
    """A batch of frames resizes as each frame alone."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 256, (3, 40, 52, 3), np.uint8))
    got = lanczos4_resize(x, 21, 17)
    for i in range(3):
        torch.testing.assert_close(got[i], lanczos4_resize(x[i], 21, 17),
                                   rtol=0, atol=0)
    with pytest.raises(ValueError, match="uint8"):
        lanczos4_resize(x.float(), 21, 17)


CASES = {
    "all placed": [[5, 6, 30, 28], [3, 4, 20, 30], [1, 2, 3, 4],
                   [0, 0, 39, 39]],
    "degenerate": [[5, 6, 30, 28], [10, 10, 10, 20], [1, 2, 3, 4],
                   [0, 0, 39, 39]],
    "two placed": [[5, 6, 30, 28], [10, 10, 10, 20], [7, 7, 2, 9],
                   [0, 0, 39, 39]],
    "none placed": [[5, 5, 5, 5], [10, 10, 10, 20], [7, 7, 2, 9],
                    [3, 3, 3, 3]],
}


@pytest.mark.parametrize("case", list(CASES))
def test_create_mosaic_matches_jax(case):
    rng = np.random.default_rng(len(case))
    imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for h, w in ((96, 96), (50, 70), (33, 41), (128, 100), (60, 60))]
    imgs[2] = np.ascontiguousarray(imgs[2][..., 0])   # a grey source
    boxes = [np.asarray(b, np.float32) for b in CASES[case]] + [
        np.asarray([1, 1, 9, 9], np.float32)]
    want, want_boxes = jax_mosaic(imgs, boxes, (SIZE, SIZE))
    got, got_boxes = create_mosaic_4_img([torch.from_numpy(i) for i in imgs],
                                         boxes, (SIZE, SIZE))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_boxes, want_boxes)
    assert got_boxes.dtype == want_boxes.dtype
    with pytest.raises(ValueError, match=">=4 images"):
        create_mosaic_4_img([torch.from_numpy(imgs[0])] * 3, boxes[:3])


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    root = jax_synthetic(str(tmp_path_factory.mktemp("mosaic") / "t"),
                         n_seq=2, n_frames=6, img_size=96, seed=3)
    return (build_index(os.path.join(root, "train"), seed=11)
            + build_index(os.path.join(root, "val"), seed=11))


@pytest.mark.parametrize("workers", [1, 2])
def test_mosaic_pipeline_matches_jax(monkeypatch, records, workers):
    """Two epochs of both pipelines with mosaic on."""
    monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    kw = dict(input_size=SIZE, batch_size=3, train=True, seed=5,
              workers=workers, mosaic=True, max_boxes=4)
    jp = JaxPipeline(records, **kw)
    tp = DataPipeline(records, device="cpu", **kw)
    for _ in range(2):
        want, got = list(jp._batches()), list(tp)
        _assert_same_batches(want, got)
        # a mosaic sample holds the boxes of up to four sources
        assert max(int(b.box_mask.sum(1).max()) for b in got) > 1


def test_validation_ignores_mosaic(records):
    kw = dict(input_size=SIZE, batch_size=3, train=False, device="cpu")
    for a, b in zip(DataPipeline(records, mosaic=True, **kw),
                    DataPipeline(records, **kw)):
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_train_main_with_mosaic(tmp_path, monkeypatch):
    """``train.main`` over ``params.yaml``'s keys with ``dataset.mosaic``
    on: it trains and validates on the CPU."""
    from uavdet_tpu_torch import prepare_dataloader, train
    from uavdet_tpu_torch.data import make_synthetic_dataset
    from uavdet_tpu_torch.utils.config import Config
    monkeypatch.chdir(tmp_path)
    make_synthetic_dataset("data/Anti-UAV-RGBT", n_seq=1, n_frames=6,
                           img_size=96, device="cpu")
    cfg = Config({
        "dataset": {
            "root_dir": "data/Anti-UAV-RGBT",
            "train_loader_path": "data/train_manifest.json",
            "val_loader_path": "data/val_manifest.json",
            "test_loader_path": "data/test_manifest.json",
            "batch_size": 2, "remote": False, "image_size": [SIZE, SIZE],
            "workers": 2, "mosaic": True, "format": "yolo"},
        "train": {
            "seed": 211,
            "trainer": {"epochs": 1, "grad_batches": 1, "train_batches": 2,
                        "val_batches": 1, "val_check_interval": 1.0,
                        "precision": 32, "grad_clip_val": None,
                        "eval_ap": False, "profiler": None},
            "checkpoint": {"dir": "logs/checkpoints", "monitor": "val_loss",
                           "mode": "min"}},
        "model": {"name": "DyYOLO", "hparams": HPARAMS}})
    prepare_dataloader.main(cfg)
    pipe, _ = train.build_pipelines(cfg, "cpu")
    assert pipe.mosaic
    final = train.main(cfg, ["--device", "cpu"])
    assert np.isfinite(final["val_loss"])
    assert os.path.exists("logs/checkpoints/last")
