"""The port's DyYOLO (uavdet_tpu_torch/models) and weight bridge
(uavdet_tpu_torch/utils/weights.py) against the JAX package's flax model.

Both sides run in f32 on the CPU from the same weights: the port's seeded
random weights (random BatchNorm statistics included), taken to flax by the
JAX package's own checkpoint import, ``import_interpreter_state_dict``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tests.test_torch_import import TorchDyYOLO
from uavdet_tpu.models import DyYOLO as JaxDyYOLO
from uavdet_tpu.utils.torch_import import import_interpreter_state_dict
from uavdet_tpu_torch.models import DYYOLO, DyYOLO, build_model
from uavdet_tpu_torch.utils.seeding import init_weights
from uavdet_tpu_torch.utils.weights import (load_flax_variables,
                                            state_dict_from_flax)

# the stem configuration of tests/test_pallas_stem_split.py:198-201
STEM_CFG = (("DyConv", 32, 3, 1), ("DyConv", 64, 3, 2), ("B", 1),
            (128, 3, 2), ("B", 8), (256, 3, 2), (128, 1, 1),
            (256, 3, 1), ("S",), (64, 1, 1), ("U",), (64, 1, 1),
            (128, 3, 1), ("S",))
# __graft_entry__.TINY_CONFIG: a 3x3 DyConv that is not the stem
TINY_CFG = (("DyConv", 8, 3, 1), (16, 3, 2), ("B", 1), (32, 3, 2), ("B", 8),
            (64, 3, 2), ("B", 8), (128, 3, 2), ("B", 1), (64, 1, 1),
            (128, 3, 1), ("S",), (32, 1, 1), ("U",), (32, 1, 1), (64, 3, 1),
            ("S",), (16, 1, 1), ("U",), (16, 1, 1), (32, 3, 1), ("S",))
CONFIGS = {"stem": STEM_CFG, "tiny": TINY_CFG,
           "full": tuple(DYYOLO.layer_config)}


def models_for(cfg, seed):
    """(flax model, its variables, the port's model) with the same weights."""
    port = init_weights(DyYOLO(cfg, attn_temperature=30.0), seed).eval()
    params, stats = import_interpreter_state_dict(
        {k: v.numpy() for k, v in port.state_dict().items()}, cfg)
    jm = JaxDyYOLO(layer_config=cfg, attn_temperature=30.0)
    return jm, {"params": params, "batch_stats": stats}, port


@pytest.fixture(scope="module")
def flax_variables():
    return {name: models_for(cfg, i)[:2]
            for i, (name, cfg) in enumerate(CONFIGS.items())}


def _port(cfg, variables):
    """The port's model loaded from flax variables (strict)."""
    model = DyYOLO(cfg, attn_temperature=30.0).eval()
    load_flax_variables(model, variables)
    return model


@pytest.mark.parametrize("name,batch", [("stem", 2), ("tiny", 2),
                                        ("full", 1)])
def test_dyyolo_matches_flax(rng, flax_variables, name, batch):
    """Per head, bbox and obj logits. f32 on both sides; the convolutions
    and the DyConv expert sums associate differently (flax contracts the
    stacked experts after the conv, the port mixes the kernel first), so
    values agree to f32 rounding grown over the depth of the network."""
    jm, v = flax_variables[name]
    x = rng.uniform(size=(batch, 64, 64, 3)).astype(np.float32)
    want = jm.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = _port(CONFIGS[name], v)(torch.from_numpy(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for field in ("bbox", "obj"):
            gv = getattr(g, field).numpy()
            wv = np.asarray(getattr(w, field))
            assert gv.shape == wv.shape
            scale = np.abs(wv).max()
            np.testing.assert_allclose(gv, wv, rtol=1e-4,
                                       atol=1e-4 * scale)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_weight_bridge_inverts_torch_import(flax_variables, name):
    """import_interpreter_state_dict(state_dict_from_flax(v)) == v, bitwise
    (the bridge only transposes and reshapes)."""
    _, v = flax_variables[name]
    params, stats = import_interpreter_state_dict(
        state_dict_from_flax(v, CONFIGS[name]), CONFIGS[name])
    for got, want in ((params, v["params"]), (stats, v["batch_stats"])):
        got_leaves = jax.tree_util.tree_leaves_with_path(got)
        want_leaves = dict(jax.tree_util.tree_leaves_with_path(want))
        assert len(got_leaves) == len(want_leaves)
        for path, leaf in got_leaves:
            np.testing.assert_array_equal(leaf, np.asarray(want_leaves[path]))


@pytest.mark.parametrize("name", ["stem", "tiny"])
def test_state_dict_is_the_reference_checkpoints(flax_variables, name):
    """The port's state_dict has the reference checkpoint's keys and shapes
    (TorchDyYOLO mirrors the reference's modules), the bridge fills every
    one of them, and the parameter counts match flax's."""
    _, v = flax_variables[name]
    cfg = CONFIGS[name]
    port = DyYOLO(cfg).state_dict()
    ref = TorchDyYOLO(cfg).state_dict()
    assert {k: tuple(t.shape) for k, t in port.items()} == \
        {k: tuple(t.shape) for k, t in ref.items()}
    sd = state_dict_from_flax(v, cfg)
    assert set(sd) == set(port)
    n_flax = sum(np.size(x) for x in jax.tree.leaves(v))
    assert sum(np.size(x) for k, x in sd.items()
               if not k.endswith("num_batches_tracked")) == n_flax
    _port(cfg, v)   # load_state_dict(strict=True)
    # and the tree is the one flax itself builds
    jm = JaxDyYOLO(layer_config=cfg, attn_temperature=30.0)
    want = jax.eval_shape(jm.init, jax.random.key(0),
                          jnp.zeros((1, 64, 64, 3)))
    assert jax.tree.map(np.shape, want) == jax.tree.map(np.shape, v)


def test_reference_checkpoint_loads_and_runs(rng):
    """A state_dict of the reference's module structure loads as it is and
    gives the reference forward (f32; the DyConv is computed differently)."""
    torch.manual_seed(0)
    ref = TorchDyYOLO(TINY_CFG).eval()
    with torch.no_grad():
        for m in ref.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.05)
                m.running_var.uniform_(0.8, 1.2)
    port = DyYOLO(TINY_CFG).eval()
    port.load_state_dict(ref.state_dict(), strict=True)
    x = rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        want = ref(torch.from_numpy(x).permute(0, 3, 1, 2))
        got = port(torch.from_numpy(x))
    for g, (w_bbox, w_obj) in zip(got, want, strict=True):
        torch.testing.assert_close(g.bbox, w_bbox, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(g.obj, w_obj, rtol=1e-4, atol=1e-4)


def test_dyyolo_constant_is_the_yaml():
    import yaml
    with open(Path(__file__).parents[1] / "conf/model/dy-yolo.yaml") as f:
        hp = yaml.safe_load(f)["hparams"]

    def lists(x):
        return [lists(i) for i in x] if isinstance(x, (list, tuple)) else x

    assert lists(DYYOLO.layer_config) == hp["layer_config"]
    assert lists(DYYOLO.anchors) == hp["anchors"]
    assert lists(DYYOLO.head_scales) == hp["head_scales"]
    assert DYYOLO.attn_temperature == hp["attn_temperature"]


def test_build_model():
    model = build_model("DyYOLO", DYYOLO, dtype=torch.bfloat16, device="cpu")
    assert isinstance(model, DyYOLO) and model.dtype == torch.bfloat16
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    assert len(model.yolo_head.detection_head) == len(DYYOLO.head_scales)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model("baseline", DYYOLO)
    with pytest.raises(ValueError):
        build_model("nope", DYYOLO)
