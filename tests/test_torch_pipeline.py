"""The port's pipeline parallelism (``uavdet_tpu_torch/parallel/pipeline.py``
and the Trainer's ``pp_devices``) against ``uavdet_tpu.parallel.pipeline``
and against the port's own plain step, on the CPU.

The stage split equals the JAX one for every config and stage count; the
stages' state_dict keys tile the model's and map to the JAX stages' keys;
the staged forward is the model's, bit for bit; one pipelined SGD step at
float64 equals the JAX pipelined step on the forced 8-device CPU mesh (S =
4 stages, M = 3 microbatches of 2 rows, as tests/test_pipeline.py) and the
port's plain step with ``grad_batches`` = M; the Trainer with
``pp_devices`` trains what the plain Trainer trains, its checkpoints
interchange with the single-device ones, and it refuses what the JAX
trainer refuses.

The JAX pipelined step costs ~70 s to trace and compile for
tests/test_models.py's TINY_DY_CONFIG (its grad through ``shard_map``,
``scan`` and ``switch``), so the JAX comparison runs ``PP_CONFIG``: the
same token kinds, two heads, 9 tokens, whose 4 stages carry a route from
stage 0 to stage 2 and a tap from stage 1 to stage 3. The port's own
comparisons run TINY_DY_CONFIG.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.test_models import TINY_DY_CONFIG
from tests.test_torch_train_step import one_torch_thread  # noqa: F401
from tests.test_torch_train_step import painted_batches
from tests.test_torch_train_trainer import ListPipe, _config_dict
from tests.test_train_step import HP, INPUT
from uavdet_tpu.models import DyYOLO as JaxDyYOLO
from uavdet_tpu.parallel import pipeline as jax_pipeline
from uavdet_tpu.training import build_optimizer as jax_build_optimizer
from uavdet_tpu.utils.torch_import import import_interpreter_state_dict
from uavdet_tpu_torch.models import DyYOLO
from uavdet_tpu_torch.parallel import (PipelinedModel, make_pp_loss,
                                       make_pp_trainer_step, split_tokens)
from uavdet_tpu_torch.training import (CheckpointManager, MetricsWriter,
                                       Trainer, build_optimizer, init_state,
                                       make_train_step)
from uavdet_tpu_torch.training.optim import (_clip_across_devices,
                                             clip_by_global_norm_)
from uavdet_tpu_torch.utils.config import Config
from uavdet_tpu_torch.utils.datatypes import BatchData
from uavdet_tpu_torch.utils.seeding import init_weights
from uavdet_tpu_torch.utils.weights import state_dict_from_flax

S, M, MB = 4, 3, 2   # stages, microbatches, rows per microbatch
TINY = tuple(tuple(t) for t in TINY_DY_CONFIG)
PP_CONFIG = (("DyConv", 8, 3, 1), (16, 3, 2), ("B", 8), (32, 3, 2), ("S",),
             (8, 1, 1), ("U",), (16, 3, 1), ("S",))


class PPHP(HP):
    """tests/test_train_step.py's hyper-parameters for PP_CONFIG's two
    heads (strides 4 and 2 at 64 px)."""
    anchors = HP.anchors[:2]

    class loss_balancing(HP.loss_balancing):
        obj_scales_w = [1.0, 2.0]


def _yaml_config(name):
    with open(f"conf/model/{name}.yaml") as f:
        return tuple(tuple(t) for t in
                     yaml.safe_load(f)["hparams"]["layer_config"])


CONFIGS = {"dy-yolo": _yaml_config("dy-yolo"),
           "baseline": _yaml_config("baseline"), "tiny": TINY}


@pytest.mark.parametrize("name, n_stages", [
    (name, n) for name, cfg in CONFIGS.items()
    for n in range(len(cfg) + 2)])
def test_split_tokens_equals_jax(name, n_stages):
    """Every stage count of every config, the out-of-range ones (0 and one
    past the token count) raising on both sides."""
    cfg = CONFIGS[name]
    if not 1 <= n_stages <= len(cfg):
        for split in (split_tokens, jax_pipeline.split_tokens):
            with pytest.raises(ValueError, match="must be in"):
                split(cfg, n_stages)
        return
    got = split_tokens(cfg, n_stages)
    assert got == jax_pipeline.split_tokens(cfg, n_stages)
    assert got[0][0] == 0 and got[-1][1] == len(cfg)
    assert all(a < b == c for (a, b), (c, _) in zip(got, got[1:]))


def _frames(seed, rows, size=INPUT):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        size=(rows, size, size, 3)))


@pytest.mark.parametrize("n_stages", [2, S])
def test_stage_keys_tile_the_model_and_map_to_jax(n_stages):
    """The stages' keys are the model's own, each key in one stage; through
    ``state_dict_from_flax`` they are the JAX stages' keys: every JAX stage's
    leaves are filled with its index + 1 and the mapped state_dict read back
    (a BatchNorm's count goes with its running statistics)."""
    pm = PipelinedModel(DyYOLO(TINY), n_stages, ["cpu"] * n_stages)
    keys = pm.stage_keys()
    flat = [k for ks in keys for k in ks]
    assert sorted(flat) == sorted(pm.model.state_dict())
    assert len(flat) == len(set(flat))

    x = jnp.zeros((2, INPUT, INPUT, 3))
    shapes = jax.eval_shape(
        lambda k: JaxDyYOLO(layer_config=TINY).init(k, x, train=False),
        jax.random.key(0))
    jpm = jax_pipeline.PipelinedModel(TINY, n_stages)
    jax.eval_shape(lambda k: jpm.init(k, x), jax.random.key(1))
    assert jpm.ranges == pm.ranges
    stage_of = {k: i for i, ks in enumerate(jpm._stage_keys) for k in ks}
    marked = {col: {"net": {
        name: jax.tree.map(lambda s, v=stage_of[name] + 1.0:
                           np.full(s.shape, v), sub)
        for name, sub in shapes[col]["net"].items()}}
        for col in ("params", "batch_stats")}
    sd = state_dict_from_flax(marked, TINY)
    for i, ks in enumerate(keys):
        for k in ks:
            if k.endswith("num_batches_tracked"):
                k = k.replace("num_batches_tracked", "running_mean")
                assert k in ks
            assert np.all(sd[k] == i + 1), (k, i)


def test_from_hparams_is_the_seeded_model():
    """``from_hparams`` builds the seeded float32 DyYOLO of the hparams
    block and splits it; a model without a layer_config raises."""
    from uavdet_tpu_torch.models import DySOEM_SimFPN
    pm = PipelinedModel.from_hparams(type("H", (HP,), {
        "layer_config": TINY}), 3, ["cpu"] * 3, seed=4)
    want = init_weights(DyYOLO(TINY), 4).state_dict()
    got = pm.model.state_dict()
    assert got.keys() == want.keys() and pm.ranges == split_tokens(TINY, 3)
    assert all(torch.equal(v, want[k]) for k, v in got.items())
    with pytest.raises(ValueError, match="no layer_config"):
        PipelinedModel(DySOEM_SimFPN(), 2, ["cpu"] * 2)


@pytest.mark.parametrize("train", [False, True])
def test_staged_forward_is_the_model_bitwise(train):
    """``sequential_apply`` of 4 stages equals the whole model's forward
    bit for bit; in train mode the BatchNorm buffers too."""
    model = init_weights(DyYOLO(TINY), 5)
    ref = copy.deepcopy(model).train(train)
    pm = PipelinedModel(model, S, ["cpu"] * S)
    x = _frames(1, MB).float()
    with torch.no_grad():
        want = ref(x)
        got = pm.sequential_apply(x, train)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert torch.equal(g.bbox, w.bbox) and torch.equal(g.obj, w.obj)
    ref_sd = ref.state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, ref_sd[k]), k


def _boxes(seed, rows, n=2):
    rng = np.random.default_rng(seed)
    wh = rng.uniform(0.1, 0.4, size=(rows, n, 2))
    cxy = rng.uniform(wh / 2 + 0.02, 1 - wh / 2 - 0.02)
    return (torch.from_numpy(np.concatenate([cxy - wh / 2, cxy + wh / 2],
                                            -1)),
            torch.ones(rows, n, dtype=torch.bool))


def _close_in_scale(got, want, tol, name):
    """|got - want| within ``tol`` of the largest |want| of the tensor."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= tol * scale, (
        name, np.abs(got - want).max() / scale)


def test_pp_step_equals_jax_pp_step_f64():
    """One SGD step of S = 4 stages over M = 3 microbatches at float64:
    the port's ``make_pp_trainer_step`` on 4 CPU stages against the JAX
    ``make_pp_train_step`` on the ('pp',) mesh, from the same weights. The
    gradient is the momentum buffer after the first step on both sides
    (optax's trace and torch's ``momentum_buffer`` start as the
    gradient)."""
    model = init_weights(DyYOLO(PP_CONFIG), 11).double()
    sd0 = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    images = _frames(2, M * MB)
    boxes, mask = _boxes(3, M * MB)

    pm = PipelinedModel(model, S, ["cpu"] * S)
    state = init_state(model, *build_optimizer(model.parameters(), PPHP))
    metrics = make_pp_trainer_step(pm, PPHP, INPUT, M, torch.float64)(
        state, BatchData(images, boxes, mask))
    names = {id(p): n for n, p in model.named_parameters()}
    grads = {names[id(p)]: s["momentum_buffer"].numpy()
             for p, s in state.optimizer.state.items()}

    with jax.enable_x64(True):
        params, stats = import_interpreter_state_dict(sd0, PP_CONFIG)
        variables = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                 {"params": params, "batch_stats": stats})
        jpm = jax_pipeline.PipelinedModel(PP_CONFIG, S, dtype=jnp.float64)
        jax.eval_shape(lambda k: jpm.init(k, jnp.zeros(
            (MB, INPUT, INPUT, 3), jnp.float64)), jax.random.key(0))
        template = jpm.split_variables(variables)
        pvec, svec = jpm.pack_params(template)
        tx = jax_build_optimizer(PPHP)
        mesh = jax_pipeline.make_pp_mesh(S)
        row, _ = jax_pipeline.pp_shardings(mesh)
        opt = tx.init(pvec)
        step = jax_pipeline.make_pp_train_step(
            jpm, mesh, tx, PPHP, INPUT, M, template,
            compute_dtype=jnp.float64)
        (pvec2, svec2, opt2), jm = step(
            (jax.device_put(pvec, row), jax.device_put(svec, row),
             jax.device_put(opt, jax.tree.map(lambda _: row, opt))),
            jnp.asarray(images.numpy()).reshape(M, MB, INPUT, INPUT, 3),
            jnp.asarray(boxes.numpy()).reshape(M, MB, -1, 4),
            jnp.asarray(mask.numpy()).reshape(M, MB, -1))

        def mapped(p, s):
            v = jpm.to_model_variables(jpm.unpack_params(p, s, template))
            return state_dict_from_flax(jax.tree.map(np.asarray, v),
                                        PP_CONFIG)

        want = mapped(pvec2, svec2)
        want_grads = mapped(opt2[0].trace, svec2)
        jm = {k: float(v) for k, v in jm.items()}

    for k in ("loss", "bbox_loss", "obj_loss"):
        np.testing.assert_allclose(float(metrics[k]), jm[k], rtol=1e-9,
                                   err_msg=k)
    for k, g in grads.items():
        _close_in_scale(g, want_grads[k], 1e-8, f"gradient {k}")
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):   # flax keeps no count
            _close_in_scale(v.numpy(), want[k], 1e-8, k)


@pytest.mark.parametrize("clip", [None, 0.5])
def test_pp_step_equals_plain_accumulation_f64(clip):
    """Two updates of the pipelined step (4 stages, 3 microbatches) against
    the plain step with ``grad_batches`` 3 on the same microbatches, at
    float64, with and without clipping (a clipped update's momentum buffer
    has the clip value's norm): losses rtol 1e-12, parameters, BatchNorm
    buffers and momentum within 1e-12 of each tensor's largest magnitude."""
    hp = type("HP3", (HP,), {"lr": 0.05})
    models = [init_weights(DyYOLO(TINY), 8).double() for _ in range(2)]
    states = [init_state(m, *build_optimizer(m.parameters(), hp))
              for m in models]
    pm = PipelinedModel(models[0], S, ["cpu"] * S)
    pp_step = make_pp_trainer_step(pm, hp, INPUT, M, torch.float64,
                                   grad_clip_val=clip)
    plain = make_train_step(models[1], hp, INPUT, torch.float64,
                            grad_batches=M, grad_clip_val=clip)
    for update in range(2):
        images = _frames(20 + update, M * MB)
        boxes, mask = _boxes(30 + update, M * MB)
        got = pp_step(states[0], BatchData(images, boxes, mask))
        want = [plain(states[1], BatchData(images[r], boxes[r], mask[r]))
                for r in (slice(m * MB, (m + 1) * MB) for m in range(M))]
        np.testing.assert_allclose(
            got["microbatch_loss"].numpy(),
            [float(w["loss"]) for w in want], rtol=1e-12)
        for k in ("loss", "bbox_loss", "obj_loss"):
            np.testing.assert_allclose(
                float(got[k]), np.mean([float(w[k]) for w in want]),
                rtol=1e-12, err_msg=k)
        if clip and update == 0:
            norm = torch.linalg.vector_norm(torch.stack([
                torch.linalg.vector_norm(s["momentum_buffer"])
                for s in states[0].optimizer.state.values()]))
            assert abs(float(norm) - clip) < 1e-12
    assert [(s.step, s.mini_step) for s in states] == [(2, 0), (2, 0)]
    want_sd = models[1].state_dict()
    for k, v in models[0].state_dict().items():
        _close_in_scale(v.numpy(), want_sd[k].numpy(), 1e-12, k)
    for p, q in zip(models[0].parameters(), models[1].parameters()):
        _close_in_scale(states[0].optimizer.state[p]["momentum_buffer"],
                        states[1].optimizer.state[q]["momentum_buffer"],
                        1e-12, "momentum")


def test_pp_loss_needs_m_microbatches_and_keeps_eval_mode():
    """``make_pp_loss`` runs the model in the mode it is in (eval mode
    leaves the BatchNorm buffers alone) and refuses another microbatch
    count."""
    model = init_weights(DyYOLO(TINY), 9).eval()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    pm = PipelinedModel(model, 2, ["cpu", "cpu"])
    loss_fn = make_pp_loss(pm, HP, INPUT, M)
    images = _frames(4, M * MB).float().reshape(M, MB, INPUT, INPUT, 3)
    boxes, mask = _boxes(5, M * MB)
    boxes, mask = boxes.float().reshape(M, MB, 2, 4), mask.reshape(M, MB, 2)
    with torch.no_grad():
        loss, metrics = loss_fn(images, boxes, mask)
    assert torch.isfinite(loss) and metrics["microbatch_loss"].shape == (M,)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    with pytest.raises(ValueError, match="expected 3"):
        loss_fn(images[:2], boxes[:2], mask[:2])


def test_clip_across_devices_is_the_global_clip():
    """The multi-device branch of ``clip_by_global_norm_`` (each device's
    squared norms summed there, the scale sent back) on two groups of
    gradients against the one-device clip of the same gradients, float64."""
    rng = np.random.default_rng(6)
    grads = [torch.from_numpy(rng.normal(size=s)) for s in
             ((3, 4), (7,), (2, 2, 2), (5,))]
    ref = [g.clone() for g in grads]
    clip_by_global_norm_(ref, 1.5)
    _clip_across_devices([grads[:2], grads[2:]], 1.5)
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-14)
    assert abs(float(torch.linalg.vector_norm(torch.cat(
        [g.flatten() for g in grads]))) - 1.5) < 1e-12


# -- the Trainer's pp_devices ----------------------------------------------

def _batches(n, batch, seed):
    return [BatchData(*b) for b in painted_batches(
        np.random.default_rng(seed), n, batch=batch)]


def _trainer(tmp_path, name, batches, val, batch_size, device="cpu",
             **trainer):
    cfg = _config_dict(tmp_path / f"ck_{name}", train_batches=len(batches),
                       **trainer)
    cfg["dataset"]["batch_size"] = batch_size
    return Trainer(Config(cfg), ListPipe(batches), ListPipe(val),
                   metrics=MetricsWriter(str(tmp_path / f"dv_{name}")),
                   device=device)


def _record_steps(trainer):
    """The train step's metrics as the step returns them (float64 here;
    the logged ones are float32)."""
    seen, build = [], trainer._build_steps

    def spied():
        train_step, eval_step = build()
        return (lambda state, batch: seen.append(train_step(state, batch))
                or seen[-1]), eval_step

    trainer._build_steps = spied
    return seen


def test_trainer_pp_equals_plain_accumulation_f64(tmp_path):
    """``pp_devices`` 2, ``pp_microbatches`` 2, batch 4, against the plain
    Trainer over the same rows cut into microbatches of 2 with
    ``grad_batches`` 2, both in float64: every microbatch loss rtol 1e-10,
    the final weights within 1e-10 of each tensor's largest magnitude, the
    validation loss (a float32 metric) rtol 1e-6."""
    batches, val = _batches(3, 4, 40), _batches(1, 4, 41)
    micro = [BatchData(*(t[r] for t in b)) for b in batches
             for r in (slice(0, 2), slice(2, 4))]
    pp = _trainer(tmp_path, "pp", batches, val, 4, pp_devices=2,
                  pp_microbatches=2)
    plain = _trainer(tmp_path, "plain", micro, val, 2, grad_batches=2)
    for t in (pp, plain):
        t.model.double()
    pp.eval_model.double()
    seen = [_record_steps(t) for t in (pp, plain)]
    finals = [t.fit() for t in (pp, plain)]
    got = torch.cat([m["microbatch_loss"] for m in seen[0]]).numpy()
    want = np.array([float(m["loss"]) for m in seen[1]])
    np.testing.assert_allclose(got, want, rtol=1e-10)
    assert pp.state.step == plain.state.step == 3
    want_sd = plain.model.state_dict()
    for k, v in pp.model.state_dict().items():
        _close_in_scale(v.numpy(), want_sd[k].numpy(), 1e-10, k)
    np.testing.assert_allclose(finals[0]["val_loss"], finals[1]["val_loss"],
                               rtol=1e-6)


def _assert_same_state(a, b):
    sb = b.model.state_dict()
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, sb[k]), k
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(a.state.optimizer.state[p]["momentum_buffer"],
                           b.state.optimizer.state[q]["momentum_buffer"])
    assert (a.state.step, a.state.mini_step) == (b.state.step,
                                                 b.state.mini_step)


@pytest.mark.parametrize("direction", ["pp to single", "single to pp"])
def test_pp_checkpoint_interchanges_with_single_device(tmp_path, direction):
    """A ``last`` checkpoint of the pp Trainer restores into a
    single-device Trainer bitwise (weights, BatchNorm buffers, momentum,
    counters), and the other way round; the restored trainer trains on."""
    batches, val = _batches(2, 4, 50), _batches(1, 4, 51)
    pp_kw = dict(pp_devices=2, pp_microbatches=2)
    first_kw, then_kw = (pp_kw, {}) if direction == "pp to single" \
        else ({}, pp_kw)
    first = _trainer(tmp_path, "a", batches, val, 4, **first_kw)
    first.fit()
    then = _trainer(tmp_path, "b", batches, val, 4, **then_kw)
    CheckpointManager(first.ckpt.ckpt_dir).restore(then.state, "last")
    _assert_same_state(then, first)
    assert (then.pm is None) == (direction == "pp to single")
    assert np.isfinite(then.fit()["val_loss"]) and then.state.step == 4


@pytest.mark.parametrize("overrides, match", [
    ({"multihost": True}, "single-process"),
    ({"fsdp_devices": 2}, "cannot combine"),
    ({"sp_devices": 2}, "cannot combine"),
    ({"ep_devices": 2}, "cannot combine"),
    ({"devices": 3}, "must equal pp_devices=2"),
    ({"pp_microbatches": 3}, "divisible by pp_microbatches=3"),
    ({"model": "DySOEM_SimFPN"}, "no layer_config"),
    ({"model": "RTMUAVDet"}, "not supported"),
    ({"device": "cuda"}, "only 1 CUDA device"),
    ({"device": ["cpu"] * 3}, "3 stage devices for pp_devices=2"),
])
def test_pp_refusals(tmp_path, monkeypatch, overrides, match):
    """The JAX trainer's refusals (``uavdet_tpu/training/trainer.py``):
    multihost, fsdp/sp/ep, ``devices`` other than 1 or pp_devices, a batch
    that ``pp_microbatches`` does not divide, fewer CUDA devices than
    stages (one visible here, by monkeypatch); and the models without a
    layer_config, and a device list of another length."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    overrides = dict(overrides)
    name = overrides.pop("model", None)
    device = overrides.pop("device", "cpu")
    cfg = _config_dict(tmp_path / "ck", pp_devices=2, **overrides)
    cfg["dataset"]["batch_size"] = 4
    if name == "DySOEM_SimFPN":
        from uavdet_tpu_torch.models import DYSOEM
        cfg["model"]["hparams"] = {k: getattr(v, "__dict__", v)
                                   for k, v in vars(DYSOEM).items()}
    if name:
        cfg["model"]["name"] = name
    with pytest.raises(ValueError, match=match):
        Trainer(Config(cfg), ListPipe([]), ListPipe([]),
                metrics=MetricsWriter(str(tmp_path / "dv")), device=device)


def test_pp_devices_one_changes_nothing(tmp_path):
    """``pp_devices: 1`` (and ``pp_microbatches: 1``) is the plain Trainer:
    no stages, validation on the model itself, the same losses and weights
    bit for bit."""
    batches, val = _batches(2, 2, 60), _batches(1, 2, 61)
    one = _trainer(tmp_path, "one", batches, val, 2, pp_devices=1,
                   pp_microbatches=1)
    plain = _trainer(tmp_path, "plain", batches, val, 2)
    assert one.pm is None and one.eval_model is one.model
    finals = [t.fit() for t in (one, plain)]
    assert finals[0] == finals[1]
    _assert_same_state(one, plain)
