"""The port's ``Trainer`` (``uavdet_tpu_torch/training/trainer.py``)
against ``uavdet_tpu.training.Trainer``, on the CPU.

Both trainers get the configuration of tests/test_trainer.py (a tiny DyYOLO
at 64 px, batch 2, SGD), the same batches of the JAX package's
``DataPipeline`` over a synthetic dataset (taken once into a list, so that
both see the same epoch), and the same initial weights: the flax state the
JAX trainer's ``fit`` starts from, loaded into ``trainer.model`` before
``fit``. The runs themselves cannot be compared beyond the first update:
the synthetic frames are flat backgrounds, so after a BatchNorm with flax's
zero bias a whole region shares one pre-activation near 0, and one
float-noise flip of its LeakyReLU derivative moves a layer's gradient by
1 % (one weight moved by 1e-6 moves the port's own loss at step 3 by 6 %).
So each of the port's steps is held against the JAX trainer's own compiled
train step on the same weights: the port's model is recorded before every
step, taken to flax by ``import_interpreter_state_dict``, and the JAX step's
loss there must equal the port's to rtol 1e-4 (f32; the convolutions
associate differently); the validation loss likewise, on the port's final
weights through the JAX trainer's eval step. The first loss of the two
``fit`` runs, from the same initial weights, agrees to rtol 1e-4 too.
"""

import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tests.test_entry_points import TINY
from tests.test_torch_train_step import one_torch_thread  # noqa: F401
from uavdet_tpu.data import DataPipeline, build_index, make_synthetic_dataset
from uavdet_tpu.training import MetricsWriter as JaxWriter
from uavdet_tpu.training import Trainer as JaxTrainer
from uavdet_tpu.training.steps import init_state as jax_init_state
from uavdet_tpu.utils.config import Config as JaxConfig
from uavdet_tpu.utils.datatypes import TrainState as JaxState
from uavdet_tpu.utils.torch_import import import_interpreter_state_dict
from uavdet_tpu_torch.training import MetricsWriter, Trainer
from uavdet_tpu_torch.utils.config import Config
from uavdet_tpu_torch.utils.weights import (load_flax_variables,
                                            state_dict_from_flax)

N_TRAIN = 4


def _config_dict(ckpt_dir, **trainer_overrides):
    trainer = {
        "epochs": 1, "input_size": [3, 64, 64], "profiler": None,
        "grad_batches": 1, "train_batches": N_TRAIN, "val_batches": 1,
        "val_check_interval": 1.0, "accelerator": "cpu", "devices": 1,
        "precision": 32, "grad_clip_val": None, "log_every_n_steps": 100}
    trainer.update(trainer_overrides)
    return {
        "dataset": {"root_dir": "x", "batch_size": 2, "remote": False,
                    "image_size": [64, 64], "workers": 1, "mosaic": False,
                    "format": "yolo"},
        "train": {"seed": 211, "trainer": trainer,
                  "checkpoint": {"dir": str(ckpt_dir), "monitor": "val_loss",
                                 "mode": "min"}},
        "model": {"name": "DyYOLO", "hparams": {
            "anchors": [[[40, 30], [60, 46], [54, 36]],
                        [[18, 14], [24, 18], [30, 12]],
                        [[6, 5], [10, 6], [13, 8]]],
            "head_scales": [16, 8, 4], "lr": 0.001, "lr_scheduler": False,
            "loss_balancing": {"obj_scales_w": [0.5, 1.0, 2.0],
                               "bbox_w": 4.0, "objectness_w": 1.0,
                               "no_obj_w": 4.0},
            "bbox_loss_fn": "mse", "attn_temperature": 30.0,
            "optim": {"name": "SGD", "momentum": 0.78},
            "layer_config": TINY}}}


class ListPipe:
    """A fixed list of batches with ``len()``: the same epoch every time."""

    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    root = make_synthetic_dataset(
        str(tmp_path_factory.mktemp("ds")), n_seq=1, n_frames=10,
        img_size=96)
    out = []
    for split, train in (("train", True), ("val", False)):
        pipe = DataPipeline(build_index(os.path.join(root, split)), 64, 2,
                            train=train, seed=1)
        out.append(ListPipe([b._replace(**{k: np.asarray(getattr(b, k))
                                           for k in b._fields})
                             for b in pipe]))
    assert len(out[0]) >= N_TRAIN
    return out


@pytest.fixture(scope="module")
def jax_run(pipes, tmp_path_factory):
    """The JAX trainer's fit with eval_ap, the state it starts from, and
    the train and eval steps it compiled."""
    d = tmp_path_factory.mktemp("jax")
    cfg = JaxConfig(_config_dict(d / "ck", eval_ap=True))
    t = JaxTrainer(cfg, *pipes, metrics=JaxWriter(str(d / "dv")))
    s0 = jax_init_state(t.model, t.tx, jax.random.key(211), 64, batch_size=2)
    steps = []
    build = t._build_steps
    t._build_steps = lambda state: steps.extend(build(state)) or tuple(steps)
    final = t.fit()
    losses = [v for _, v in t.metrics._series[("train", "loss")]]
    return dict(final=final, losses=losses, steps=steps, tx=t.tx, init={
        "params": s0.params, "batch_stats": s0.batch_stats})


class RecordingPipe(ListPipe):
    """Records ``model``'s state_dict before each batch it hands out: the
    weights each train step starts from."""

    def __init__(self, batches, model_of):
        super().__init__(batches)
        self.model_of = model_of
        self.before = []

    def __iter__(self):
        for b in self.batches:
            self.before.append({k: v.detach().numpy().copy() for k, v in
                                self.model_of().state_dict().items()})
            yield b


def _jax_state(sd, tx):
    params, stats = import_interpreter_state_dict(sd, TINY)
    return JaxState(params=params, batch_stats=stats,
                    opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))


def _port(tmp_path, pipes, init=None, name="dv", **overrides):
    cfg = Config(_config_dict(tmp_path / "ck", **overrides))
    t = Trainer(cfg, *pipes, metrics=MetricsWriter(str(tmp_path / name)),
                device="cpu")
    if init is not None:
        load_flax_variables(t.model, init)
    return t


def test_fit_matches_jax_trainer(pipes, jax_run, tmp_path):
    holder = []
    train = RecordingPipe(pipes[0].batches, lambda: holder[0].model)
    t = _port(tmp_path, (train, pipes[1]), jax_run["init"], eval_ap=True)
    holder.append(t)
    final = t.fit()
    losses = [v for _, v in t.metrics._series[("train", "loss")]]
    assert len(losses) == len(jax_run["losses"]) == N_TRAIN
    np.testing.assert_allclose(losses[0], jax_run["losses"][0], rtol=1e-4)
    jax_train, jax_eval = jax_run["steps"]
    updated = []
    for i, (loss, sd, batch) in enumerate(zip(losses, train.before,
                                              train.batches)):
        new, m = jax_train(_jax_state(sd, jax_run["tx"]), batch)
        np.testing.assert_allclose(loss, float(m["loss"]), rtol=1e-4,
                                   err_msg=f"step {i}")
        updated.append(state_dict_from_flax(
            {"params": new.params, "batch_stats": new.batch_stats}, TINY))
    # the first update (no momentum yet) from the same weights: the change
    # of the parameters agrees in norm and direction to the 1 % that the
    # flips above leave (an lr or gradient-scale bug shows as a ratio of 2
    # or more)
    before, after, want = train.before[0], train.before[1], updated[0]
    keys = [k for k in want if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))]
    d_got = np.concatenate([(after[k] - before[k]).ravel() for k in keys])
    d_want = np.concatenate([(np.asarray(want[k]) - before[k]).ravel()
                             for k in keys])
    assert abs(np.linalg.norm(d_got) / np.linalg.norm(d_want) - 1) < 0.02
    assert np.linalg.norm(d_got - d_want) / np.linalg.norm(d_want) < 0.05
    final_sd = {k: v.numpy() for k, v in t.model.state_dict().items()}
    m = jax_eval(_jax_state(final_sd, jax_run["tx"]), pipes[1].batches[0])
    np.testing.assert_allclose(final["val_loss"], float(m["loss"]),
                               rtol=1e-4)
    assert final["val_AP"] >= 0.0 and "val_AP" in jax_run["final"]
    assert t.state.step == N_TRAIN
    dv = tmp_path / "dv"
    assert (dv / "metrics.json").exists()
    assert (dv / "plots" / "metrics" / "val" / "AP.tsv").exists()
    names = sorted(p.name for p in (tmp_path / "ck").iterdir())
    assert names[0].startswith("best-00-") and names[1:] == ["last",
                                                              "meta.json"]


def test_resume_restores_step_and_weights(pipes, tmp_path):
    t = _port(tmp_path, pipes, train_batches=2)
    t.fit()
    saved = {k: v.clone() for k, v in t.model.state_dict().items()}
    t2 = _port(tmp_path, pipes, name="dv2", train_batches=2)
    assert not torch.equal(t2.model.state_dict()["layers.0.weights"],
                           saved["layers.0.weights"])
    t2.ckpt.restore(t2.state, "last")
    for k, v in saved.items():
        assert torch.equal(t2.model.state_dict()[k], v), k
    assert t2.state.step == 2
    t3 = _port(tmp_path, pipes, name="dv3", train_batches=2)
    final = t3.fit(resume=True)
    assert t3.state.step == 4 and np.isfinite(final["val_loss"])


def test_check_val_every_n_epoch(pipes, tmp_path):
    t = _port(tmp_path, pipes, epochs=3, check_val_every_n_epoch=2,
              train_batches=2)
    calls = []
    orig = t.validate
    t.validate = lambda *a, **k: (calls.append(1), orig(*a, **k))[1]
    final = t.fit()
    assert len(calls) == 1 and np.isfinite(final["val_loss"])


def test_metric_fetches_are_batched(pipes, tmp_path):
    """One fetch drains the 4 steps' metrics at the validation, one more
    fetches the validation's: 2 host syncs in the epoch."""
    t = _port(tmp_path, pipes)
    t.fit()
    assert t._n_metric_syncs == 2
    tsv = (tmp_path / "dv" / "plots" / "metrics" / "train"
           / "loss.tsv").read_text().strip().splitlines()
    assert [int(r.split("\t")[0]) for r in tsv[1:]] == [0, 1, 2, 3]
    mj = json.loads((tmp_path / "dv" / "metrics.json").read_text())
    assert mj["epoch"] == 0 and "step" in mj
    t2 = _port(tmp_path / "k1", pipes, log_every_n_steps=1)
    t2.fit()
    assert t2._n_metric_syncs == N_TRAIN + 1


def test_nan_guard_skips_poisoned_batch(pipes, tmp_path):
    """A NaN batch between two good ones leaves the model exactly where a
    run without it ends: no update, the BatchNorm buffers put back."""
    tr, va = pipes
    b0, b1, b2 = tr.batches[:3]
    poisoned = b1._replace(image=np.full_like(b1.image, np.nan))
    runs = []
    for batches, n in (([b0, poisoned, b2], 3), ([b0, b2], 2)):
        t = _port(tmp_path / str(n), (ListPipe(batches), va),
                  nan_guard=True, train_batches=n)
        runs.append((t.fit(), t.model.state_dict()))
    (fa, sa), (fb, sb) = runs
    for k, v in sa.items():
        assert torch.equal(v, sb[k]), k
    assert fa["val_loss"] == fb["val_loss"]
    t = _port(tmp_path / "many", (ListPipe([poisoned] * 3), va),
              nan_guard=True, nan_guard_retries=1, train_batches=3)
    with pytest.raises(FloatingPointError, match="too many"):
        t.fit()


@pytest.mark.parametrize("key, value", [
    ("devices", 2), ("fsdp_devices", 2), ("sp_devices", 2),
    ("ep_devices", 2), ("pp_devices", 2), ("multihost", True)])
def test_multi_device_keys_raise(pipes, tmp_path, key, value):
    """pp_devices trains over two stages on the CPU in this one process
    (tests/test_torch_pipeline.py holds it against the plain step); devices,
    fsdp_devices, sp_devices, ep_devices and multihost are accepted: in one
    process with no process group (none running, none named by the
    environment) the trainer warns as the JAX one does and trains on one
    device (tests/test_torch_parallel.py, tests/test_torch_multihost.py,
    tests/test_torch_spatial.py and tests/test_torch_experts.py run them on
    process groups)."""
    if key == "pp_devices":
        t = _port(tmp_path, pipes, train_batches=1, **{key: value})
        assert t.mesh is None and t.pm is not None
        assert len(t.pm.stages) == value and t.eval_model is not t.model
        assert np.isfinite(t.fit()["val_loss"])
        return
    t = _port(tmp_path, pipes, train_batches=1, **{key: value})
    assert t.mesh is None and t.train_model is t.model
    assert np.isfinite(t.fit()["val_loss"])


def test_remat_names_and_fold_early(pipes, tmp_path):
    with pytest.raises(ValueError, match="no counterpart"):
        _port(tmp_path, pipes, remat="nothing_saveable")
    t = _port(tmp_path, pipes, fold_early=True, remat="dots_saveable",
              train_batches=1)
    assert np.isfinite(t.fit()["val_loss"])


def test_validate_reuses_detector(pipes, tmp_path):
    t = _port(tmp_path, pipes, epochs=2, eval_ap=True, train_batches=1)
    seen = []
    orig = t.validate

    def spy(state, eval_step):
        out = orig(state, eval_step)
        seen.append(t._detector)
        return out

    t.validate = spy
    t.fit()
    assert len(seen) == 2 and seen[0] is seen[1] is not None


def test_profiler_writes_a_trace(pipes, tmp_path, monkeypatch):
    """``profiler`` traces the fit with torch.profiler into logs/profile,
    relative to the working directory as in the JAX package."""
    monkeypatch.chdir(tmp_path)
    t = _port(tmp_path, pipes, profiler="simple", train_batches=1)
    t.fit()
    trace = json.loads((tmp_path / "logs" / "profile" / "trace.json")
                       .read_text())
    assert trace["traceEvents"]


def test_epoch_interval_schedule_and_accumulation(pipes, tmp_path):
    """``lr_scheduler_interval: epoch`` holds the schedule at the epoch
    (update // updates per epoch: 4 batches / grad_batches 2 = 2), and
    ``grad_batches`` 2 makes one update per two microbatches."""
    from uavdet_tpu_torch.training import cyclic_triangular2
    cfg = _config_dict(tmp_path / "ck", grad_batches=2)
    cfg["model"]["hparams"].update(lr_scheduler=True,
                                   lr_scheduler_interval="epoch")
    t = Trainer(Config(cfg), *pipes, metrics=MetricsWriter(
        str(tmp_path / "dv")), device="cpu")
    sched = cyclic_triangular2(1e-4, 1e-3)
    assert [t.state.scheduler.lr_lambdas[0](u) for u in range(5)] == [
        sched(u // 2) for u in range(5)]
    t.fit()
    assert (t.state.step, t.state.mini_step) == (N_TRAIN // 2, 0)
    assert t.state.optimizer.param_groups[0]["lr"] == sched(1)
