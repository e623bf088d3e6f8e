"""The port's detector (uavdet_tpu_torch/inference.py) against the JAX
package's ``make_detector``, end to end on the CPU.

The JAX detector runs its Pallas stem in interpret mode with the unfolded
tail (``fold_early=False``), f32 compute; the port runs the plain versions
of its kernels, also f32 outside the stem. Both stems round to bf16 at the
same places; their f32 sums associate differently, which flips about one
stem element in 10^4 by one bf16 ulp. Through the f32 tail that moved
scores (~1e-2) by at most 4e-5 relative and boxes by ~1e-3 px when this
test was written: below any gap that decides a suppression here, so
``valid`` must be equal; scores and boxes agree to the stated tolerances,
except that two candidates whose scores tie to within that noise may trade
places.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tests.test_torch_model import CONFIGS, models_for
from uavdet_tpu.inference import make_detector as jax_make_detector
from uavdet_tpu.inference import preprocess as jax_preprocess
from uavdet_tpu_torch import kernels
from uavdet_tpu_torch.inference import make_detector, preprocess
from uavdet_tpu_torch.models import DYYOLO

REPO = Path(__file__).resolve().parents[1]


class SmallHP:
    """Two heads: the stem configuration's."""
    anchors = [[[40, 30], [60, 46], [54, 36]],
               [[18, 14], [24, 18], [30, 12]]]


class TinyHP:
    anchors = [[[40, 30], [60, 46], [54, 36]],
               [[18, 14], [24, 18], [30, 12]],
               [[6, 5], [10, 6], [13, 8]]]


HPARAMS = {"stem": SmallHP, "tiny": TinyHP, "full": DYYOLO}


@pytest.fixture(scope="module")
def models():
    return {name: models_for(cfg, 10 + i)
            for i, (name, cfg) in enumerate(CONFIGS.items())}


def _frames(rng, batch, h=64, w=64):
    return (rng.uniform(size=(batch, h, w, 3)) * 255).astype(np.uint8)


def _assert_same_detections(got, want):
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert valid.sum(axis=1).min() > 10
    gs, ws = got.scores.numpy(), np.asarray(want.scores)
    gb, wb = got.boxes.numpy(), np.asarray(want.boxes)
    np.testing.assert_allclose(gs, ws, rtol=1e-4, atol=1e-7)
    # boxes in pixels, up to a few hundred. Two candidates whose scores tie
    # to within that noise may trade places, so a box must match the one in
    # its slot or in a slot next to it that holds an equal score.
    k = gs.shape[1]
    near = np.abs(np.arange(k)[:, None] - np.arange(k)[None, :]) <= 2
    same_box = np.isclose(gb[:, :, None], wb[:, None], rtol=1e-4,
                          atol=1e-2).all(-1)
    same_score = np.isclose(gs[:, :, None], ws[:, None], rtol=1e-4,
                            atol=1e-7)
    matched = (same_box & same_score & near).any(-1) | ~valid
    assert matched.all(), np.argwhere(~matched)
    in_place = np.isclose(gb, wb, rtol=1e-4, atol=1e-2).all(-1)
    assert (~in_place & valid).sum() <= 0.01 * valid.sum()


@pytest.mark.parametrize("name,batch", [("stem", 2), ("stem", 1),
                                        ("full", 2), ("full", 1)])
def test_detector_matches_jax_stem_path(rng, models, name, batch):
    """uint8 frames at the detector size: straight into the stem on both
    sides. Batch 1 holds the port's single global top-k against JAX's
    per-head batch-1 branch."""
    jm, v, port = models[name]
    hp = HPARAMS[name]
    x = _frames(rng, batch)
    want = jax_make_detector(
        jm, hp, 64, compute_dtype=jnp.float32, pallas_stem_variables=v,
        pallas_stem_interpret=True, fold_early=False)(v, jnp.asarray(x))
    got = make_detector(port, hp, 64, compute_dtype=torch.float32)(
        torch.from_numpy(x))
    _assert_same_detections(got, want)


def test_detector_matches_jax_plain_path(rng, models):
    """A model without the stem (a 3x3 DyConv 3->8 first) runs whole,
    after ``preprocess``, on both sides: f32 throughout."""
    jm, v, port = models["tiny"]
    x = _frames(rng, 2)
    want = jax_make_detector(jm, TinyHP, 64, compute_dtype=jnp.float32,
                             pre_nms_topk=128, max_det=50)(v, jnp.asarray(x))
    got = make_detector(port, TinyHP, 64, compute_dtype=torch.float32,
                        pre_nms_topk=128, max_det=50)(torch.from_numpy(x))
    _assert_same_detections(got, want)


def test_preprocess_matches_jax(rng):
    """Resize (2, 90, 160) -> 64 and /255 in f32: the same weight matrices,
    products summed in another order."""
    x = _frames(rng, 2, 90, 160)
    want = np.asarray(jax_preprocess(jnp.asarray(x), 64, jnp.float32))
    got = preprocess(torch.from_numpy(x), 64, torch.float32)
    assert got.dtype == torch.float32 and got.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_frames_of_another_size_are_preprocessed(rng, models):
    """uint8 frames not at the detector size are resized first, and the
    result keeps the fixed-shape contract: invalid slots are zero."""
    _, _, port = models["stem"]
    d = make_detector(port, SmallHP, 64, compute_dtype=torch.float32,
                      max_det=30)(torch.from_numpy(_frames(rng, 2, 80, 96)))
    assert d.boxes.shape == (2, 30, 4) and d.scores.shape == (2, 30)
    assert torch.isfinite(d.boxes).all() and torch.isfinite(d.scores).all()
    assert (d.boxes[~d.valid] == 0).all() and (d.scores[~d.valid] == 0).all()
    # survivors first, by descending score
    for row, s in zip(d.valid, d.scores):
        n = int(row.sum())
        assert row[:n].all() and (s[:n].diff() <= 0).all()


def test_cpu_detector_launches_no_kernel(rng, models):
    _, _, port = models["stem"]
    make_detector(port, SmallHP, 64, compute_dtype=torch.float32)(
        torch.from_numpy(_frames(rng, 1)))
    assert kernels.launch_counts() == dict.fromkeys(
        ("stem_l1", "stem_l2", "nms", "dyconv", "stem_fused",
         "stem_l2_stage", "post_stem_block", "group_norm1", "bn_act"), 0)


def test_port_imports_no_jax():
    """The port runs where JAX is absent: importing it loads neither JAX
    nor the JAX package (nor PIL, cv2 or matplotlib, which the card's host
    lacks), and builds no kernel and no nvJPEG library."""
    code = ("import sys\n"
            "import uavdet_tpu_torch.inference, uavdet_tpu_torch.kernels\n"
            "import uavdet_tpu_torch.utils.seeding\n"
            "import uavdet_tpu_torch.utils.weights\n"
            "import uavdet_tpu_torch.ops.dyconv\n"
            "import uavdet_tpu_torch.models.dysoem_simfpn\n"
            "import uavdet_tpu_torch.models.baseline\n"
            "import uavdet_tpu_torch.ops.block\n"
            "import uavdet_tpu_torch.utils.timing\n"
            "import uavdet_tpu_torch.utils.compare\n"
            "import uavdet_tpu_torch.scripts.l2_ablate\n"
            "import uavdet_tpu_torch.scripts.block_ablate\n"
            "import uavdet_tpu_torch.scripts.kernel_probe\n"
            "import uavdet_tpu_torch.scripts.roofline_table\n"
            "import uavdet_tpu_torch.scripts.section_probe\n"
            "import uavdet_tpu_torch.scripts.cfg3_section_probe\n"
            "import uavdet_tpu_torch.scripts.perf_probe\n"
            "import uavdet_tpu_torch.scripts.topk_compact_probe\n"
            "import uavdet_tpu_torch.scripts.chain_slope\n"
            "import uavdet_tpu_torch.scripts.bblock_probe\n"
            "import uavdet_tpu_torch.training\n"
            "import uavdet_tpu_torch.training.optim\n"
            "import uavdet_tpu_torch.training.steps\n"
            "import uavdet_tpu_torch.training.checkpoint\n"
            "import uavdet_tpu_torch.training.dvclive_io\n"
            "import uavdet_tpu_torch.training.trainer\n"
            "import uavdet_tpu_torch.parallel\n"
            "import uavdet_tpu_torch.parallel.dryrun\n"
            "import uavdet_tpu_torch.parallel.spatial\n"
            "import uavdet_tpu_torch.parallel.experts\n"
            "import uavdet_tpu_torch.parallel.pipeline\n"
            "import uavdet_tpu_torch.ops.boxes, uavdet_tpu_torch.ops.decode\n"
            "import uavdet_tpu_torch.ops.targets, uavdet_tpu_torch.ops.losses\n"
            "import uavdet_tpu_torch.ops.map\n"
            "import uavdet_tpu_torch.utils.datatypes\n"
            "import uavdet_tpu_torch.utils.config\n"
            "import uavdet_tpu_torch.data, uavdet_tpu_torch.data.antiuav\n"
            "import uavdet_tpu_torch.data.remote, uavdet_tpu_torch.data.jpeg\n"
            "import uavdet_tpu_torch.data.frames\n"
            "import uavdet_tpu_torch.data.mosaic\n"
            "import uavdet_tpu_torch.data.synthetic\n"
            "import uavdet_tpu_torch.data.pipeline\n"
            "import uavdet_tpu_torch.prepare_dataloader\n"
            "import uavdet_tpu_torch.train, uavdet_tpu_torch.evaluate\n"
            "import uavdet_tpu_torch.scripts.detect\n"
            "import uavdet_tpu_torch.utils.viz\n"
            "import uavdet_tpu_torch.export, uavdet_tpu_torch.utils.debug\n"
            "import uavdet_tpu_torch.utils.torch_import\n"
            "import uavdet_tpu_torch.scripts.export_detector\n"
            "import uavdet_tpu_torch.scripts.port_reference_checkpoint\n"
            "import uavdet_tpu_torch.models.rtm_uav_det\n"
            "import uavdet_tpu_torch.training.rtm\n"
            "import uavdet_tpu_torch.ops.resize\n"
            "import uavdet_tpu_torch.bench, uavdet_tpu_torch._bench_reference\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'uavdet_tpu', 'yaml')]\n"
            "assert not bad, bad\n"
            "kernels = uavdet_tpu_torch.kernels\n"
            "assert not kernels.build.cache_info().currsize\n"
            "jpeg = uavdet_tpu_torch.data.jpeg\n"
            "assert not jpeg.build.cache_info().currsize\n"
            "assert not jpeg.codec.cache_info().currsize\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('PIL', 'cv2', 'matplotlib')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
