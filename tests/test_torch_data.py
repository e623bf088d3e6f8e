"""The port's data hand-off (``uavdet_tpu_torch/data/``) against the JAX
package's ``uavdet_tpu/data/``, on the CPU.

* Manifests (``build_index`` + ``save_manifest``) and the synthetic writer's
  files are byte for byte the JAX package's.
* ``DataPipeline`` on the CPU against the JAX one on the same manifest, for
  train and val, ``workers`` 1 and 3, ``fmt`` yolo and custom and
  ``drop_last`` both ways, two epochs: batch membership and ``box_mask``
  equal, boxes within 1e-4 px (both sides scale them with the same numpy
  operations), pixels within one unit in 255 and 0.2 units on average (cv2
  interpolates uint8 in fixed point, torch in float32). The JAX side runs
  with its native loader switched off (``uavdet_tpu.data.native.get_lib``
  patched in the test), so it takes its PIL + cv2 path.
* The remote filesystems through the fakes of tests/test_remote.py, the
  frame stage against the JAX transform, the JPEG reference that the card
  holds nvJPEG's decode against (PIL's own files and decodes, the JAX
  writer's bytes), and the pipeline's failures: an unreadable file raises from ``__iter__``, a CUDA
  pipeline on a host without a card raises (no fallback),
  ``set_local_rows`` returns True, or False for a remote ``fs``
  (``mosaic=True`` and the sharded decode are ported: see
  tests/test_torch_mosaic.py and tests/test_torch_multihost.py).
"""

import filecmp
import io
import os
import threading

import numpy as np
import pytest
import torch

import uavdet_tpu.data.native as jax_native
from tests.test_remote import FakeSFTP
from tests.test_torch_train_step import one_torch_thread  # noqa: F401
from uavdet_tpu.data import DataPipeline as JaxPipeline
from uavdet_tpu.data import build_index as jax_build_index
from uavdet_tpu.data import make_synthetic_dataset as jax_synthetic
from uavdet_tpu.data import make_transform as jax_make_transform
from uavdet_tpu.data import save_manifest as jax_save_manifest
from uavdet_tpu_torch.data import (DataPipeline, build_index, load_manifest,
                                   make_synthetic_dataset, make_transform,
                                   save_manifest)
from uavdet_tpu_torch.data import frames
from uavdet_tpu_torch.data import jpeg
from uavdet_tpu_torch.data.mosaic import mosaic_layout
from uavdet_tpu_torch.data.remote import FsspecFileSystem, SFTPFileSystem

SIZE = 64


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The same synthetic tree written by both packages' writers."""
    base = tmp_path_factory.mktemp("data")
    kw = dict(n_seq=2, n_frames=6, img_size=96, seed=3)
    jax_root = jax_synthetic(str(base / "jax"), **kw)
    port_root = make_synthetic_dataset(str(base / "port"), device="cpu",
                                       **kw)
    return jax_root, port_root


@pytest.fixture(scope="module")
def records(trees):
    jax_root, _ = trees
    return (build_index(os.path.join(jax_root, "train"), seed=11)
            + build_index(os.path.join(jax_root, "val"), seed=11))


@pytest.fixture
def cv2_path(monkeypatch):
    """The JAX pipeline without its native loader: PIL decode, cv2 resize
    and warp."""
    monkeypatch.setattr(jax_native, "get_lib", lambda: None)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_synthetic_writer_is_byte_equal(trees):
    jax_root, port_root = trees
    names = _files(jax_root)
    assert names == _files(port_root) and len(names) > 50
    match, mismatch, errors = filecmp.cmpfiles(jax_root, port_root, names,
                                               shallow=False)
    assert not mismatch and not errors


def test_manifests_are_byte_equal(trees, tmp_path):
    jax_root, _ = trees
    for split in ("train", "val", "test"):
        a, b = tmp_path / f"jax_{split}.json", tmp_path / f"port_{split}.json"
        jax_save_manifest(jax_build_index(os.path.join(jax_root, split),
                                          seed=11), str(a))
        save_manifest(build_index(os.path.join(jax_root, split), seed=11),
                      str(b))
        assert a.read_bytes() == b.read_bytes()
        assert load_manifest(str(b)) == jax_build_index(
            os.path.join(jax_root, split), seed=11)


def _assert_same_batches(want, got, size=SIZE):
    assert len(want) == len(got) > 0
    mean = []
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.box_mask.numpy(), w.box_mask)
        np.testing.assert_allclose(g.boxes.numpy() * size, w.boxes * size,
                                   rtol=0, atol=1e-4)
        assert g.image.dtype == torch.float32
        assert tuple(g.image.shape) == w.image.shape
        # both sides are k / 255 in float32: compare on the uint8 grid
        d = np.abs(np.round(g.image.numpy() * 255) - np.round(w.image * 255))
        assert d.max() <= 1
        mean.append(d.mean())
    assert np.mean(mean) <= 0.2


@pytest.mark.parametrize("train", [True, False], ids=["train", "val"])
@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("fmt", ["yolo", "custom"])
@pytest.mark.parametrize("drop_last", [True, False])
def test_pipeline_matches_jax(cv2_path, records, train, workers, fmt,
                              drop_last):
    """Two epochs of both pipelines over one manifest."""
    kw = dict(input_size=SIZE, batch_size=3, train=train, seed=5,
              workers=workers, fmt=fmt, drop_last=drop_last)
    jp = JaxPipeline(records, **kw)
    tp = DataPipeline(records, device="cpu", **kw)
    assert len(tp) == len(jp)
    for _ in range(2):
        _assert_same_batches(list(jp._batches()), list(tp))


def test_frame_stage_matches_jax_transform():
    """``make_transform`` on painted frames of the RGB and infrared
    streams' sizes, to the detectors' 640 px: the same boxes (and affine
    draws), pixels within one unit and 0.2 on average. (At a 4-5x
    downscale, 512x640 to 128 px, the mean reads 0.22-0.24 units: cv2's
    11-bit fixed-point weights against float32 ones.)"""
    rng = np.random.default_rng(0)
    for (h, w) in ((1080, 1920), (512, 640)):
        img = rng.integers(0, 80, (h, w, 3), dtype=np.uint8)
        img[h // 4:h // 2, w // 3:w // 2] = (255, 240, 220)
        boxes = np.asarray([[w / 3, h / 4, w / 2, h / 2]], np.float32)
        for train in (True, False):
            want_img, want_boxes = jax_make_transform(640, train)(
                img, boxes, np.random.default_rng(7))
            got_img, got_boxes = make_transform(640, train)(
                img, boxes, np.random.default_rng(7))
            np.testing.assert_array_equal(got_boxes, want_boxes)
            d = np.abs(np.round(got_img * 255) - np.round(want_img * 255))
            assert d.max() <= 1 and d.mean() <= 0.2


def test_frame_stage_groups_by_source_size():
    """A batch of two source sizes gives each frame what it gives alone."""
    rng = np.random.default_rng(1)
    imgs = [torch.from_numpy(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
            for h, w in ((90, 160), (64, 80), (90, 160), (64, 64))]
    mats = [frames.affine_matrix(np.random.default_rng(i), SIZE)
            for i in range(4)]
    batch = frames.frame_stage(imgs, SIZE, mats)
    assert batch.shape == (4, SIZE, SIZE, 3)
    for i, img in enumerate(imgs):
        torch.testing.assert_close(batch[i], frames.frame_stage(
            [img], SIZE, [mats[i]])[0], rtol=0, atol=0)


def _pil_jpeg(img, **kw):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _pil_planes(data):
    """PIL's (libjpeg's) decode of a JPEG as RGB and as its upsampled
    YCbCr, before the colour conversion."""
    from PIL import Image
    with Image.open(io.BytesIO(data)) as im:
        rgb = np.array(im.convert("RGB"))
    with Image.open(io.BytesIO(data)) as im:
        im.draft("YCbCr", im.size)
        ycc = np.array(im)
    return rgb, ycc


@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_ycc_to_rgb_is_libjpegs(subsampling):
    """``jpeg.ycc_to_rgb`` against libjpeg's decode, bit for bit. Frames of
    16 x 16 one-colour blocks (cropped off the block grid) keep each
    subsampled chroma plane constant over 8 x 8 blocks, so libjpeg's planes
    before upsampling are read off the blocks' interiors; libjpeg's
    upsampled planes and RGB must then be what ``ycc_to_rgb`` makes of
    them: the fancy upsampling at every block and frame edge, and the
    fixed-point colour conversion."""
    rng = np.random.default_rng(subsampling)
    blocks = rng.integers(0, 256, (5, 7, 3), dtype=np.uint8)
    h, w = 75, 107
    img = np.kron(blocks, np.ones((16, 16, 1), np.uint8))[:h, :w]
    rgb, ycc = _pil_planes(_pil_jpeg(img, quality=100,
                                     subsampling=subsampling))
    fy, fx = {0: (1, 1), 1: (1, 2), 2: (2, 2)}[subsampling]
    centres = ycc[8::16, 8::16, 1:]              # one value per block
    ch, cw = -(-h // fy), -(-w // fx)
    planes = [torch.from_numpy(ycc[..., 0])]
    for k in range(2):
        per_block = np.kron(centres[..., k],
                            np.ones((16 // fy, 16 // fx), np.uint8))
        planes.append(torch.from_numpy(
            np.ascontiguousarray(per_block[:ch, :cw])))
    css = {0: jpeg.CSS_444, 1: jpeg.CSS_422, 2: jpeg.CSS_420}[subsampling]
    np.testing.assert_array_equal(jpeg.ycc_to_rgb(planes, css).numpy(), rgb)


def test_ycc_to_rgb_on_photo_like_frames():
    """The colour conversion alone on the reference's colour frames
    (libjpeg's own upsampled planes, as 4:4:4) and on a grey JPEG."""
    frames = jpeg.reference_frames()
    for name, (data, want) in jpeg.load_reference().items():
        if frames[name][0].ndim == 2:
            continue   # grey: below
        _, ycc = _pil_planes(data)
        planes = [torch.from_numpy(np.ascontiguousarray(ycc[..., k]))
                  for k in range(3)]
        np.testing.assert_array_equal(
            jpeg.ycc_to_rgb(planes, jpeg.CSS_444).numpy(), want)
    grey = np.random.default_rng(0).integers(0, 256, (33, 41), np.uint8)
    rgb, _ = _pil_planes(_pil_jpeg(grey))
    from PIL import Image
    with Image.open(io.BytesIO(_pil_jpeg(grey))) as im:
        y = torch.from_numpy(np.array(im))
    np.testing.assert_array_equal(
        jpeg.ycc_to_rgb([y], jpeg.CSS_GRAY).numpy(), rgb)


def test_jpeg_reference_is_pils(tmp_path):
    """The committed reference is what ``write_reference`` makes here: PIL's
    JPEGs of ``reference_frames`` (4:2:0 at its defaults, and 4:2:2, grey
    and 4:4:4) and PIL's decode of them."""
    from PIL import Image, JpegImagePlugin
    path = tmp_path / "ref.npz"
    jpeg.write_reference(path)
    fresh, kept = jpeg.load_reference(path), jpeg.load_reference()
    frames = jpeg.reference_frames()
    assert sorted(fresh) == sorted(kept) == sorted(frames)
    for name, (data, rgb) in kept.items():
        assert data == fresh[name][0], name
        np.testing.assert_array_equal(rgb, fresh[name][1], err_msg=name)
        img, options = frames[name]
        with Image.open(io.BytesIO(data)) as im:
            np.testing.assert_array_equal(np.array(im.convert("RGB")), rgb)
            assert im.size == img.shape[1::-1]
            if img.ndim == 2:
                assert im.mode == "L"
            else:   # PIL's default 4:2:0 unless stated
                assert JpegImagePlugin.get_sampling(im) == options.get(
                    "subsampling", 2), name


def test_jpeg_reference_frames_are_the_jax_writers(tmp_path):
    """The reference's two synthetic frames are byte for byte the files the
    JAX package's writer makes of them."""
    root = jax_synthetic(str(tmp_path / "jax"), splits=("val",), n_seq=1,
                         n_frames=1, img_size=128, seed=0)
    ref = jpeg.load_reference()
    for cam in ("visible", "infrared"):
        path = os.path.join(root, "val", "val_seq00", cam, f"{cam}-0000.jpg")
        with open(path, "rb") as f:
            assert f.read() == ref[cam][0], cam


def _tree_files(root):
    out = {}
    for rel in _files(root):
        with open(os.path.join(root, rel), "rb") as f:
            out["/remote/" + rel] = f.read()
    return out


def test_remote_filesystems(cv2_path, trees):
    """SFTP (an in-memory paramiko fake) and fsspec's memory:// give the
    local tree's manifest and batches; ``read_bytes`` hands out the file."""
    fsspec = pytest.importorskip("fsspec")
    _, port_root = trees
    files = _tree_files(port_root)
    mem = fsspec.filesystem("memory")
    for path, data in files.items():
        with mem.open(path, "wb") as f:
            f.write(data)
    local = build_index(os.path.join(port_root, "val"), seed=11)
    want = list(DataPipeline(local, SIZE, 2, train=False, device="cpu"))
    for fs in (SFTPFileSystem(sftp=FakeSFTP(files)), FsspecFileSystem(mem)):
        recs = build_index("/remote/val", seed=11, fs=fs)
        assert [os.path.relpath(r["img_path"], "/remote") for r in recs] == \
            [os.path.relpath(r["img_path"], port_root) for r in local]
        assert fs.read_bytes(recs[0]["img_path"]) == \
            files[recs[0]["img_path"]]
        got = list(DataPipeline(recs, SIZE, 2, train=False, fs=fs,
                                workers=3, device="cpu"))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            torch.testing.assert_close(g.image, w.image, rtol=0, atol=0)
            torch.testing.assert_close(g.boxes, w.boxes, rtol=0, atol=0)


def test_unreadable_file_raises(records):
    broken = [dict(records[0], img_path="/nonexistent/frame.jpg")] + records
    pipe = DataPipeline(broken, SIZE, 2, train=True, workers=2, device="cpu")
    with pytest.raises(FileNotFoundError):
        list(pipe)


def test_cuda_pipeline_raises_without_a_card(records):
    """No host fallback: a pipeline on the card fails where there is none
    (this host has no CUDA device)."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    pipe = DataPipeline(records, SIZE, 2, train=False)
    assert pipe.device.type == "cuda"
    with pytest.raises((RuntimeError, AssertionError)):
        next(iter(pipe))
    with pytest.raises(ValueError, match="no decoder"):
        frames.decode([b""], "meta")


def test_early_stop_ends_the_producer(records):
    """A consumer that stops after one batch leaves no thread behind."""
    before = threading.active_count()
    pipe = DataPipeline(records, SIZE, 2, train=True, workers=3,
                        prefetch=1, device="cpu")
    for _ in pipe:
        break
    assert threading.active_count() == before


def test_not_ported_options_raise(records):
    # the mosaic path and the multi-host decode are ported now
    # (tests/test_torch_mosaic.py, tests/test_torch_multihost.py)
    assert DataPipeline(records, SIZE, 2, train=True, mosaic=True,
                        device="cpu").mosaic
    pipe = DataPipeline(records, SIZE, 2, train=True, device="cpu")
    assert pipe.set_local_rows([0]) is True and pipe.local_rows == {0}
    assert DataPipeline(records, SIZE, 2, train=True, fs=object(),
                        device="cpu").set_local_rows([0]) is False
    with pytest.raises(ValueError, match="format"):
        DataPipeline(records, SIZE, 2, train=True, fmt="coco", device="cpu")


def test_mosaic_layout_matches_jax():
    from uavdet_tpu.data.mosaic import mosaic_layout as jax_layout
    rng = np.random.default_rng(2)
    sizes = [(int(h), int(w)) for h, w in rng.integers(40, 200, (4, 2))]
    boxes = [np.asarray([5, 6, 30, 28], np.float32),
             np.asarray([10, 10, 10, 20], np.float32),   # degenerate
             np.asarray([1, 2, 3, 4], np.float32),
             np.asarray([0, 0, 39, 39], np.float32)]
    got, want = mosaic_layout(sizes, boxes, (64, 64)), jax_layout(
        sizes, boxes, (64, 64))
    assert [(i, q) for i, q, _ in got] == [(i, q) for i, q, _ in want]
    np.testing.assert_array_equal([b for *_, b in got],
                                  [b for *_, b in want])
