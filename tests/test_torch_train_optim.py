"""The port's optimizers, schedules, checkpoints and its own copies of the
JAX package's numpy modules, on the CPU.

``build_optimizer`` + ``optim.update`` against the optax chain of
``uavdet_tpu.training.build_optimizer`` on a small parameter vector: the
same float32 updates in the same order up to the association of a few sums
(the global norm, the mean of two gradients), so rtol 1e-6 over 12
updates. Adam's differ more: optax computes its bias corrections
1 - 0.999^t in float32, where 0.999 is off by 1.3e-8, 1.3e-5 of
1 - 0.999 at the first update (torch computes them in float64). That moves
the first update by 6.5e-6 of itself, 3.3e-7 at lr 0.05, and less later:
atol 1e-5 over the 12 updates, with the same rtol.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax.numpy as jnp
import optax

from tests.test_torch_train_step import one_torch_thread  # noqa: F401
from uavdet_tpu.ops.map import MeanAveragePrecision as JaxMAP
from uavdet_tpu.training import MetricsWriter as JaxWriter
from uavdet_tpu.training.optim import build_optimizer as jax_build_optimizer
from uavdet_tpu.training.optim import cyclic_triangular2 as jax_triangular2
from uavdet_tpu.utils import config as jax_config
from uavdet_tpu_torch.ops.map import MeanAveragePrecision
from uavdet_tpu_torch.training import (CheckpointManager, MetricsWriter,
                                       build_optimizer, cyclic_triangular2,
                                       init_state)
from uavdet_tpu_torch.training.optim import update
from uavdet_tpu_torch.utils import config

N_PARAMS, N_UPDATES = 10, 12


def _hp(name, lr_scheduler, momentum=0.78, lr=0.05):
    return SimpleNamespace(lr=lr, lr_scheduler=lr_scheduler,
                           optim=SimpleNamespace(name=name,
                                                 momentum=momentum))


def _problem(rng, n_micro):
    """Per microbatch a quadratic loss 0.5 a p^2 + b p: gradient a p + b."""
    p0 = rng.normal(size=N_PARAMS).astype(np.float32)
    a = rng.uniform(0.5, 2.0, (n_micro, N_PARAMS)).astype(np.float32)
    b = rng.normal(scale=2.0, size=(n_micro, N_PARAMS)).astype(np.float32)
    return p0, a, b


@pytest.mark.parametrize("name, sched, k, clip, per_epoch", [
    ("SGD", False, 1, None, None),
    ("SGD", True, 2, 0.5, None),
    ("SGD", True, 1, None, 3),
    ("Adam", True, 2, 0.5, 3),
    ("Adam", False, 1, None, None),
])
def test_optimizer_matches_optax(rng, name, sched, k, clip, per_epoch):
    hp = _hp(name, sched)
    n_micro = N_UPDATES * k
    p0, a, b = _problem(rng, n_micro)

    tx = jax_build_optimizer(hp, grad_batches=k, grad_clip_val=clip,
                             steps_per_epoch=per_epoch)
    params = jnp.asarray(p0)
    opt_state = tx.init(params)
    want = []
    for t in range(n_micro):
        g = jnp.asarray(a[t]) * params + jnp.asarray(b[t])
        u, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, u)
        want.append(np.asarray(params))

    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    optimizer, scheduler = build_optimizer([p], hp, steps_per_epoch=per_epoch)
    state = init_state(torch.nn.Linear(1, 1), optimizer, scheduler)
    for t in range(n_micro):
        loss = (0.5 * torch.from_numpy(a[t]) * p ** 2
                + torch.from_numpy(b[t]) * p).sum()
        (loss / k).backward()
        update(state, k, clip)
        np.testing.assert_allclose(p.detach().numpy(), want[t], rtol=1e-6,
                                   atol=1e-5 if name == "Adam" else 1e-7,
                                   err_msg=f"microbatch {t}")
    assert state.step == N_UPDATES == scheduler.last_epoch
    assert state.mini_step == 0
    if clip:   # the first update's mean gradient is clipped
        g0 = np.mean([a[t] * p0 + b[t] for t in range(k)], axis=0)
        assert np.linalg.norm(g0) > 4 * clip


def test_cyclic_triangular2_matches_jax():
    steps = [0, 1, 1999, 4000, 4001, 7999, 8000, 12345, 16000, 20000, 41234]
    got = [cyclic_triangular2(0.01, 0.1)(s) for s in steps]
    want = [float(jax_triangular2(0.01, 0.1)(jnp.asarray(s))) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_sgd_momentum_is_not_cycled():
    """CyclicLR's default would cycle SGD's momentum; the port's schedule
    leaves it alone, as optax does."""
    p = torch.nn.Parameter(torch.ones(3))
    optimizer, scheduler = build_optimizer([p], _hp("SGD", True))
    for _ in range(5):
        p.grad = torch.ones(3)
        optimizer.step()
        scheduler.step()
    assert optimizer.param_groups[0]["momentum"] == 0.78
    assert optimizer.param_groups[0]["lr"] == pytest.approx(
        cyclic_triangular2(0.005, 0.05)(5))
    with pytest.raises(ValueError, match="Invalid optimizer"):
        build_optimizer([p], _hp("RMSprop", False))


def _tiny_state(seed, k_mom=0.78):
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(4, 6),
                                torch.nn.BatchNorm1d(6),
                                torch.nn.Linear(6, 1))
    optimizer, scheduler = build_optimizer(model.parameters(),
                                           _hp("SGD", True, k_mom))
    return init_state(model, optimizer, scheduler)


def _micro(state, x, k=2):
    state.model.train()
    (state.model(x).pow(2).mean() / k).backward()
    update(state, k)


def test_checkpoint_restores_training_mid_accumulation(rng, tmp_path):
    """Save in the middle of an accumulation, go on; restore the
    checkpoint into a fresh state, go on the same way: bitwise the same
    parameters, BatchNorm buffers, optimizer and scheduler state."""
    xs = [torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32))
          for _ in range(8)]
    state = _tiny_state(0)
    for x in xs[:3]:
        _micro(state, x)
    assert (state.step, state.mini_step) == (1, 1)
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    ckpt.save(state, 0, {"val_loss": 1.5})
    for x in xs[3:]:
        _micro(state, x)

    fresh = _tiny_state(1)
    assert not torch.equal(fresh.model[0].weight, state.model[0].weight)
    ckpt.restore(fresh, "last")
    assert (fresh.step, fresh.mini_step) == (1, 1)
    for x in xs[3:]:
        _micro(fresh, x)
    for (n, a), b in zip(state.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        assert torch.equal(a, b), n
    assert state.scheduler.last_epoch == fresh.scheduler.last_epoch == 4
    assert (state.optimizer.param_groups[0]["lr"]
            == fresh.optimizer.param_groups[0]["lr"])


def test_checkpoint_best_last_policy(tmp_path):
    state = _tiny_state(0)
    d = tmp_path / "ck"
    ckpt = CheckpointManager(str(d), monitor="val_loss", mode="min")
    assert not ckpt.has_checkpoint("last")
    assert ckpt.save(state, 0, {"val_loss": 2.0})
    assert not ckpt.save(state, 1, {"val_loss": 3.0})
    assert ckpt.save(state, 2, {"val_loss": 1.25})
    assert sorted(p.name for p in d.iterdir()) == [
        "best-02-1.2500", "last", "meta.json"]
    meta = json.loads((d / "meta.json").read_text())
    assert meta == {"best_value": 1.25, "best_path": "best-02-1.2500",
                    "epoch": 2}
    again = CheckpointManager(str(d), monitor="val_loss", mode="min")
    assert again.best_path == "best-02-1.2500"
    assert not again.save(state, 3, {"val_loss": 1.5})
    high = CheckpointManager(str(tmp_path / "hi"), monitor="val_AP",
                             mode="max")
    high.save(state, 0, {"val_AP": 0.1})
    assert high.save(state, 1, {"val_AP": 0.2})
    assert high.best_path == "best-01-0.2000"


def test_map_copy_equals_jax_package(rng):
    ours, theirs = MeanAveragePrecision(), JaxMAP()
    for _ in range(4):
        gt = rng.uniform(20, 200, size=(int(rng.integers(0, 4)), 4))
        pred = np.concatenate([gt + rng.normal(scale=4, size=gt.shape),
                               rng.uniform(20, 200, size=(3, 4))])
        scores = rng.uniform(size=len(pred))
        for m in (ours, theirs):
            m.update(pred, scores, gt)
    assert ours.compute() == theirs.compute()


def test_metrics_writer_copy_equals_jax_package(tmp_path):
    for cls, d in ((MetricsWriter, "port"), (JaxWriter, "jax")):
        w = cls(str(tmp_path / d))
        for s in range(3):
            w.log("train/loss", 1.0 / (s + 1))
            w.next_step()
        w.log("val/AP", 0.25)
        w.set_epoch(0)
        w.flush()
    files = sorted(p.relative_to(tmp_path / "port")
                   for p in (tmp_path / "port").rglob("*") if p.is_file())
    assert len(files) == 3
    for f in files:
        assert ((tmp_path / "port" / f).read_text()
                == (tmp_path / "jax" / f).read_text())


def test_config_copy_equals_jax_package(tmp_path):
    for model in ("dy-yolo", "dy-soem_fpn", "baseline"):
        assert (config.load_config("conf", model=model).to_dict()
                == jax_config.load_config("conf", model=model).to_dict())
    assert (config.load_params("params.yaml").to_dict()
            == jax_config.load_params("params.yaml").to_dict())
    cfg = config.Config({"a": {"b": 1}})
    assert cfg.a.b == 1 and cfg.a.get("c", 2) == 2 and "a" in cfg
    config.save_params(cfg, str(tmp_path / "p.yaml"))
    assert config.load_params(str(tmp_path / "p.yaml")).to_dict() == {
        "a": {"b": 1}}
