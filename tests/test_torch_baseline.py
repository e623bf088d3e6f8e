"""The port's BaselineModel, ``preprocess_dual`` and dual-stream detector
against the JAX package, on the CPU.

Both sides run in f32 from the same weights: the port's seeded random
weights (random BatchNorm statistics included), taken to flax by the JAX
package's own checkpoint import. The BaselineModel has no Pallas kernel; the
dual-stream DyYOLO runs the JAX stem kernels in interpret mode and the
port's plain versions, as tests/test_torch_detector.py does.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tests.test_torch_detector import (HPARAMS, SmallHP, TinyHP,
                                       _assert_same_detections)
from tests.test_torch_import import TorchDyYOLO
from tests.test_torch_model import CONFIGS, models_for
from uavdet_tpu.inference import make_detector as jax_make_detector
from uavdet_tpu.inference import preprocess_dual as jax_preprocess_dual
from uavdet_tpu.models import BaselineModel as JaxBaselineModel
from uavdet_tpu.utils.torch_import import import_interpreter_state_dict
from uavdet_tpu_torch import kernels
from uavdet_tpu_torch.inference import make_detector, preprocess_dual
from uavdet_tpu_torch.models import BASELINE, BaselineModel, build_model
from uavdet_tpu_torch.utils.seeding import init_weights, seeded_model
from uavdet_tpu_torch.utils.weights import (load_flax_variables,
                                            state_dict_from_flax)

# TINY_CONFIG without its DyConv: three heads at narrow widths
TINY_BASE = ((8, 3, 1), (16, 3, 2), ("B", 1), (32, 3, 2), ("B", 8),
             (64, 3, 2), ("B", 8), (128, 3, 2), ("B", 1), (64, 1, 1),
             (128, 3, 1), ("S",), (32, 1, 1), ("U",), (32, 1, 1), (64, 3, 1),
             ("S",), (16, 1, 1), ("U",), (16, 1, 1), (32, 3, 1), ("S",))
BASE_CONFIGS = {"tiny": TINY_BASE, "full": tuple(BASELINE.layer_config)}
BASE_HPARAMS = {"tiny": TinyHP, "full": BASELINE}


def baseline_models_for(cfg, seed):
    """(flax model, its variables, the port's model) with the same weights."""
    port = init_weights(BaselineModel(cfg), seed).eval()
    params, stats = import_interpreter_state_dict(
        {k: v.numpy() for k, v in port.state_dict().items()}, cfg)
    return (JaxBaselineModel(layer_config=cfg),
            {"params": params, "batch_stats": stats}, port)


@pytest.fixture(scope="module")
def baselines():
    return {name: baseline_models_for(cfg, 20 + i)
            for i, (name, cfg) in enumerate(BASE_CONFIGS.items())}


@pytest.fixture(scope="module")
def dyyolo_stem():
    return models_for(CONFIGS["stem"], 31)


def _frames(rng, batch, h=64, w=64):
    return (rng.uniform(size=(batch, h, w, 3)) * 255).astype(np.uint8)


@pytest.mark.parametrize("name,batch", [("tiny", 2), ("full", 1)])
def test_baseline_matches_flax(rng, baselines, name, batch):
    """Per head, bbox and obj logits at 64 px, f32 on both sides, the port's
    model loaded from the flax variables through the weight bridge; values
    agree to f32 rounding grown over the depth of the network."""
    jm, v, _ = baselines[name]
    port = BaselineModel(BASE_CONFIGS[name]).eval()
    load_flax_variables(port, v)
    x = rng.uniform(size=(batch, 64, 64, 3)).astype(np.float32)
    want = jm.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for field in ("bbox", "obj"):
            gv = getattr(g, field).numpy()
            wv = np.asarray(getattr(w, field))
            assert gv.shape == wv.shape
            np.testing.assert_allclose(gv, wv, rtol=1e-4,
                                       atol=1e-4 * np.abs(wv).max())


@pytest.mark.parametrize("name,batch", [("tiny", 2), ("tiny", 1),
                                        ("full", 2), ("full", 1)])
def test_baseline_detector_matches_jax(rng, baselines, name, batch):
    """uint8 frames at the detector size through ``make_detector`` on both
    sides, f32: ``valid`` equal, scores rtol 1e-4. Batch 1 holds the port's
    single global top-k against JAX's per-head batch-1 branch."""
    jm, v, port = baselines[name]
    hp = BASE_HPARAMS[name]
    x = _frames(rng, batch)
    want = jax_make_detector(jm, hp, 64, compute_dtype=jnp.float32)(
        v, jnp.asarray(x))
    got = make_detector(port, hp, 64, compute_dtype=torch.float32)(
        torch.from_numpy(x))
    _assert_same_detections(got, want)


def test_baseline_detector_resizes_other_frames(rng, baselines):
    jm, v, port = baselines["tiny"]
    x = _frames(rng, 2, 80, 96)
    want = jax_make_detector(jm, TinyHP, 64, compute_dtype=jnp.float32,
                             pre_nms_topk=128, max_det=50)(v, jnp.asarray(x))
    got = make_detector(port, TinyHP, 64, compute_dtype=torch.float32,
                        pre_nms_topk=128, max_det=50)(torch.from_numpy(x))
    _assert_same_detections(got, want)


def test_baseline_weight_bridge_and_reference_keys(baselines):
    """The state_dict has the reference checkpoint's keys and shapes
    (TorchDyYOLO mirrors the reference's modules), and the bridge inverts
    the JAX package's import bitwise."""
    _, v, port = baselines["tiny"]
    ref = TorchDyYOLO(TINY_BASE).state_dict()
    assert {k: tuple(t.shape) for k, t in port.state_dict().items()} == \
        {k: tuple(t.shape) for k, t in ref.items()}
    sd = state_dict_from_flax(v, TINY_BASE)
    assert set(sd) == set(ref)
    for k, t in port.state_dict().items():
        np.testing.assert_array_equal(sd[k], t.numpy())
    jm = JaxBaselineModel(layer_config=TINY_BASE)
    want = jax.eval_shape(jm.init, jax.random.key(0),
                          jnp.zeros((1, 64, 64, 3)))
    assert jax.tree.map(np.shape, want) == jax.tree.map(np.shape, v)


def test_baseline_constant_is_the_yaml():
    import yaml
    with open(Path(__file__).parents[1] / "conf/model/baseline.yaml") as f:
        hp = yaml.safe_load(f)["hparams"]

    def lists(x):
        return [lists(i) for i in x] if isinstance(x, (list, tuple)) else x

    assert lists(BASELINE.layer_config) == hp["layer_config"]
    assert lists(BASELINE.anchors) == hp["anchors"]
    assert lists(BASELINE.head_scales) == hp["head_scales"]


def test_build_baseline():
    model = build_model("baseline", BASELINE, dtype=torch.bfloat16,
                        device="cpu")
    assert isinstance(model, BaselineModel)
    assert model.dtype == torch.bfloat16
    assert sum(p.numel() for p in model.parameters()) == 61_518_349
    assert len(model.yolo_head.detection_head) == 3
    seeded = seeded_model("baseline", BASELINE, 0, device="cpu")
    assert seeded.dtype == torch.float32 and not seeded.training


def test_preprocess_dual_matches_jax(rng):
    """Both modalities from their own sizes to 64 px, /255, f32, stacked
    modality-major: the same resize matrices, products summed in another
    order."""
    rgb, ir = _frames(rng, 2, 108, 192), _frames(rng, 2, 51, 64)
    want = np.asarray(jax_preprocess_dual(jnp.asarray(rgb), jnp.asarray(ir),
                                          64, jnp.float32))
    got = preprocess_dual(torch.from_numpy(rgb), torch.from_numpy(ir), 64,
                          torch.float32)
    assert got.dtype == torch.float32 and got.shape == (4, 64, 64, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert preprocess_dual(torch.from_numpy(rgb), torch.from_numpy(ir),
                           64).dtype == torch.bfloat16


def test_dual_detector_matches_jax_stem_path(rng, dyyolo_stem):
    """DyYOLO's dual-stream entry: the preprocessed f32 frames go through the
    stem kernels on both sides (Pallas in interpret mode, the port's plain
    versions), which round them to bf16; the tail is f32."""
    jm, v, port = dyyolo_stem
    rgb, ir = _frames(rng, 1, 108, 192), _frames(rng, 1, 51, 64)
    want = jax_make_detector(
        jm, SmallHP, 64, compute_dtype=jnp.float32, dual=True,
        pallas_stem_variables=v, pallas_stem_interpret=True,
        fold_early=False)(v, jnp.asarray(rgb), jnp.asarray(ir))
    got = make_detector(port, SmallHP, 64, compute_dtype=torch.float32,
                        dual=True)(torch.from_numpy(rgb),
                                   torch.from_numpy(ir))
    assert got.valid.shape == (2, 300)
    _assert_same_detections(got, want)


def test_dual_detector_matches_jax_baseline(rng, baselines):
    jm, v, port = baselines["tiny"]
    rgb, ir = _frames(rng, 2, 108, 192), _frames(rng, 2, 51, 64)
    want = jax_make_detector(jm, TinyHP, 64, compute_dtype=jnp.float32,
                             dual=True, pre_nms_topk=128, max_det=50)(
        v, jnp.asarray(rgb), jnp.asarray(ir))
    got = make_detector(port, TinyHP, 64, compute_dtype=torch.float32,
                        dual=True, pre_nms_topk=128, max_det=50)(
        torch.from_numpy(rgb), torch.from_numpy(ir))
    assert got.valid.shape == (4, 50)
    _assert_same_detections(got, want)


def test_cpu_paths_launch_no_kernel(rng, baselines, dyyolo_stem):
    kernels.reset_launch_counts()
    make_detector(baselines["tiny"][2], TinyHP, 64,
                  compute_dtype=torch.float32)(torch.from_numpy(
                      _frames(rng, 1)))
    make_detector(dyyolo_stem[2], HPARAMS["stem"], 64,
                  compute_dtype=torch.float32, dual=True)(
        torch.from_numpy(_frames(rng, 1, 40, 48)),
        torch.from_numpy(_frames(rng, 1, 30, 36)))
    assert set(kernels.launch_counts()) == {
        "stem_l1", "stem_l2", "nms", "dyconv", "stem_fused", "stem_l2_stage",
        "post_stem_block"}
    assert not any(kernels.launch_counts().values())
