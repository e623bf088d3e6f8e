"""The port's ``ep`` axis (``uavdet_tpu_torch/parallel/experts.py``: the
dynamic convs' expert stacks sliced over the ``ep`` ranks) on the CPU,
alone and with ``sp`` and ``fsdp``, against one process and against the
JAX package's ``make_sharded_train_step``.

One two-rank and one four-rank gloo group (``parallel.dryrun.launch``) run
every check of the module (``tests/torch_sp_ep_worker.py:job``) while this
process computes its references and runs the JAX step. SGD with momentum,
from the same seeded weights, two global batches of 4 at 64 px:

* float64 train steps on ep 2 over the tiny DyYOLO (E = 4: each rank keeps
  half of its DyConv's 4 x 8 stacked output channels) and over
  DySOEM_SimFPN (E = 3: each rank's half of E * Co cuts through the
  second expert), ``grad_batches`` 2 with clipping by the global norm
  under ep, sp 2 x ep 2 over a tiny DyYOLO with both DyConv forms (3x3 and
  1x1; the slices' gradients summed over the two sp ranks that hold the
  same slice) and fsdp 2 x ep 2 under FSDP2 (the slices left to ep) equal
  one process: losses rtol 1e-5, the gradients of every update within
  1e-6 of each tensor's largest, BatchNorm running statistics and the
  final parameters rtol 1e-5;
* an ep checkpoint round trip: the two ranks' checkpoint restores in one
  process (the whole stacks and their momentum), and a one-process
  checkpoint on the two ranks (each its slices, bitwise);
* ``Trainer.fit`` with ``devices: 2``, ``ep_devices: 2`` equals one
  process's (validation loss, train loss rtol 1e-5, ``val_AP``: the
  detector runs a copy with the slices gathered);
* the sp 2 x ep 2 float32 step on four ranks against the JAX step on its
  mesh of data 2, sp 2, ep 2 (8 devices), from the same flax init and
  batch of 8: the loss rtol 1e-4, the parameters after the update rtol
  1e-4 atol 1e-5 (tests/test_torch_parallel.py's DDP-vs-JAX limits).
"""

import copy
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from tests.test_models import TINY_DY_CONFIG
from tests.test_torch_multihost import _trainer_config
from tests.test_torch_parallel import CFG, HP, noise_batches
from tests.test_torch_spatial import DHP, _weights, assert_step_equal
from tests.test_torch_train_step import one_torch_thread  # noqa: F401
from tests.test_train_step import HP as JAX_HP
from tests.test_train_step import _synthetic_batch
from tests.torch_dist_worker import ListPipe, run_steps
from tests.torch_sp_ep_worker import build
from uavdet_tpu.models import DyYOLO as JaxDyYOLO
from uavdet_tpu.parallel import make_mesh as jax_make_mesh
from uavdet_tpu.parallel import make_sharded_train_step, shard_batch
from uavdet_tpu.parallel.mesh import state_shardings
from uavdet_tpu.training import build_optimizer as jax_build_optimizer
from uavdet_tpu.training import init_state as jax_init_state
from uavdet_tpu_torch.models import DyYOLO
from uavdet_tpu_torch.models.dysoem_simfpn import DySOEM_SimFPN
from uavdet_tpu_torch.parallel import check_layout_supported
from uavdet_tpu_torch.parallel.dryrun import launch
from uavdet_tpu_torch.training import (CheckpointManager, MetricsWriter,
                                       Trainer, build_optimizer, init_state)
from uavdet_tpu_torch.utils.config import Config
from uavdet_tpu_torch.utils.datatypes import BatchData
from uavdet_tpu_torch.utils.weights import state_dict_from_flax

SIZE = 64
F32, F64 = torch.float32, torch.float64
# both DyConv forms: the 3x3 stacked-expert conv and the 1x1 mix-first
# matmul (tests/test_parallel.py::test_sp_ep_grads_exact_at_f64's model)
BOTH_CFG = CFG[:2] + (("DyConv", 16, 1, 1),) + CFG[2:]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """-> (the cases, this process's references, the two ranks' results,
    the four ranks' results)."""
    tmp = tmp_path_factory.mktemp("experts")
    rng = np.random.default_rng(23)
    batches = noise_batches(rng, 2, 4)
    dy = dict(kind="dyyolo", state_dict=_weights(
        DyYOLO(CFG, attn_temperature=30.0), 3), layer_config=CFG, hp=HP,
        size=SIZE, batches=batches)
    both = dict(dy, state_dict=_weights(DyYOLO(BOTH_CFG,
                                               attn_temperature=30.0), 7),
                layer_config=BOTH_CFG)
    ep2, cases = (1, 1, 1, 2), {}
    cases["ep_dyyolo"] = dict(dy, axes=ep2, ckpt_dir=str(tmp / "two"),
                              restore_dir=str(tmp / "one"))
    cases["ep_dysoem"] = dict(kind="dysoem", state_dict=_weights(
        DySOEM_SimFPN(), 6), hp=DHP, size=SIZE, batches=batches, axes=ep2)
    cases["ep_accum_clip"] = dict(dy, axes=ep2, grad_batches=2, clip=0.5)
    four = {"sp2_ep2": dict(both, axes=(1, 1, 2, 2)),
            "fsdp2_ep2": dict(dy, axes=(1, 2, 1, 2), fsdp=True)}
    refs = {}
    for name, c in {**cases, **four}.items():
        losses, grads, final, state = run_steps(
            build(c["kind"], c["state_dict"], c.get("layer_config")), c["hp"],
            SIZE, c["batches"], c.get("grad_batches", 1), None,
            c.get("clip"), F64)
        refs[name] = {"losses": losses, "grads": grads, "final": final}
        if name == "ep_dyyolo":   # the one-process checkpoint the ranks load
            CheckpointManager(str(tmp / "one")).save(state, 0,
                                                     {"val_loss": 1.0})
            refs["one_saved"] = (final, {
                n: state.optimizer.state[p]["momentum_buffer"].numpy()
                for n, p in state.model.named_parameters()}, state.step)

    # the JAX step's init and batch; the port's four ranks take both
    jm = JaxDyYOLO(layer_config=TINY_DY_CONFIG)
    tx = jax_build_optimizer(JAX_HP)
    jbatch = _synthetic_batch(np.random.default_rng(211), batch=8)
    st = jax_init_state(jm, tx, jax.random.key(0), SIZE, batch_size=8)
    jsd = {k: torch.from_numpy(np.array(v)) for k, v in state_dict_from_flax(
        {"params": st.params, "batch_stats": st.batch_stats}, CFG).items()}
    four["jax"] = dict(dy, state_dict=jsd, axes=(1, 1, 2, 2), dtype=F32,
                       hp=SimpleNamespace(**dict(vars(HP),
                                                 lr=float(JAX_HP.lr))),
                       batches=[tuple(np.asarray(a) for a in jbatch)])
    train = [BatchData(*b) for b in noise_batches(rng, 2, 4)]
    val = [BatchData(*b) for b in noise_batches(rng, 1, 4)]
    two_spec = dict(steps=cases, trainers={"ep2": _trainer_config(
        tmp / "t_ep", devices=2, ep_devices=2)}, train=train, val=val,
        workdir=str(tmp))
    with ThreadPoolExecutor(2) as ex:
        two = ex.submit(launch, "tests.torch_sp_ep_worker:job", 2,
                        args=(two_spec,), timeout=240)
        fut = ex.submit(launch, "tests.torch_sp_ep_worker:job", 4,
                        args=({"steps": four},), timeout=240)
        mesh = jax_make_mesh(n_data=2, n_fsdp=1, n_sp=2, n_ep=2)
        st = jax.tree.map(jax.device_put, st,
                          state_shardings(st, mesh, ep=True))
        _, compile_step = make_sharded_train_step(
            jm, tx, JAX_HP, SIZE, mesh, spatial=True, ep=True)
        st, m = compile_step(st)(st, shard_batch(jbatch, mesh, spatial=True))
        refs["jax"] = {"loss": float(m["loss"]), "final": state_dict_from_flax(
            {"params": st.params, "batch_stats": st.batch_stats}, CFG)}
        refs["trainer"] = Trainer(
            Config(copy.deepcopy(_trainer_config(tmp / "t_one"))),
            ListPipe(train), ListPipe(val),
            metrics=MetricsWriter(str(tmp / "dv_one")), device="cpu").fit()
        return {**cases, **four}, refs, two.result(), fut.result()


def _ranks(setup, name):
    return setup[2] if name in setup[2][0]["steps"] else setup[3]


@pytest.mark.parametrize("case", ["ep_dyyolo", "ep_dysoem", "ep_accum_clip",
                                  "sp2_ep2", "fsdp2_ep2"])
def test_ep_step_equals_one_process(setup, case):
    ranks = _ranks(setup, case)
    for rank in ranks:
        assert_step_equal(rank["steps"][case], setup[1][case])
    a, b = (r["steps"][case]["final"] for r in ranks[:2])
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_batch_rows_shard_over_ep_not_sp(setup):
    """On sp 2 x ep 2 the two ranks of an sp group (the same ep coordinate)
    hold the same rows of the batch of 4, and the ep groups split it."""
    rows = {r["steps"]["sp2_ep2"]["coordinate"]: r["steps"]["sp2_ep2"]["rows"]
            for r in setup[3]}
    assert rows == {(0, 0, 0, 0): [0, 1], (0, 0, 1, 0): [0, 1],
                    (0, 0, 0, 1): [2, 3], (0, 0, 1, 1): [2, 3]}


@pytest.mark.parametrize("case,want", [
    ("ep_dyyolo", {"layers.0.weights": (16, 3, 3, 3)}),
    ("ep_dysoem", {"soem_0.experts.kernel": (3, 3, 128, 96),
                   "soem_0.experts.bias": (96,),
                   "soem_1.experts.kernel": (3, 3, 256, 192),
                   "soem_1.experts.bias": (192,),
                   "soem_2.experts.kernel": (3, 3, 512, 384),
                   "soem_2.experts.bias": (384,)}),
    ("sp2_ep2", {"layers.0.weights": (16, 3, 3, 3),
                 "layers.2.weights": (32, 16, 1, 1)})])
def test_ep_ranks_hold_half_of_each_stack(setup, case, want):
    for rank in _ranks(setup, case):
        assert rank["steps"][case]["slices"] == want


def test_ep_checkpoint_restores_in_one_process(setup):
    """The two ranks' checkpoint: one process restores the whole stacks,
    bitwise the ranks' final state, and their momentum at full shape (the
    one-process run's within float64 rounding)."""
    cases, refs, two = setup[:3]
    saved = two[0]["steps"]["ep_dyyolo"]["final"]
    model = build("dyyolo", cases["ep_dyyolo"]["state_dict"], CFG).to(F64)
    state = init_state(model, *build_optimizer(model.parameters(), HP))
    CheckpointManager(cases["ep_dyyolo"]["ckpt_dir"]).restore(state)
    sd = model.state_dict()
    for k, v in saved.items():
        assert np.array_equal(sd[k].numpy(), v), k
    assert state.step == 2 and state.mini_step == 0
    _, momentum, _ = refs["one_saved"]
    for name, p in model.named_parameters():
        got = state.optimizer.state[p]["momentum_buffer"].numpy()
        np.testing.assert_allclose(got, momentum[name], rtol=1e-9,
                                   atol=1e-12, err_msg=name)


def test_one_process_checkpoint_restores_on_ep_ranks(setup):
    final, momentum, step = setup[1]["one_saved"]
    for rank in setup[2]:
        got = rank["steps"]["ep_dyyolo"]
        for k, v in final.items():
            assert np.array_equal(got["restored"][k], v), k
        assert got["restored_momentum"].keys() == {"layers.0.weights"}
        assert np.array_equal(got["restored_momentum"]["layers.0.weights"],
                              momentum["layers.0.weights"])
        assert got["restored_step"] == (step, 0)


def test_ep_trainer_equals_one_process(setup):
    want = setup[1]["trainer"]
    for rank in setup[2]:
        got = rank["trainers"]["ep2"]
        assert got["mesh"] == {"data": 1, "fsdp": 1, "sp": 1, "ep": 2}
        assert got["slices"] == 1 and got["step"] == 2
        for k in ("val_loss", "train_loss"):
            np.testing.assert_allclose(got["final"][k], want[k], rtol=1e-5)
        assert got["final"]["val_AP"] == pytest.approx(want["val_AP"],
                                                       abs=1e-6)


def test_sp_ep_step_against_jax_sharded_step(setup):
    """The port's sp 2 x ep 2 step on four ranks against the JAX step on its
    data 2 x sp 2 x ep 2 mesh, from the same flax init and batch."""
    refs = setup[1]
    for rank in setup[3]:
        got = rank["steps"]["jax"]
        np.testing.assert_allclose(got["losses"][0, 0], refs["jax"]["loss"],
                                   rtol=1e-4)
        for k, v in refs["jax"]["final"].items():
            if k.endswith("num_batches_tracked"):   # flax keeps no count
                continue
            np.testing.assert_allclose(got["final"][k], np.asarray(v),
                                       rtol=1e-4, atol=1e-5, err_msg=k)


def test_layout_checks_take_ep():
    check_layout_supported(ep=2)
    check_layout_supported(sp=2, ep=2)
    assert check_layout_supported(pp=2) is None   # pp: parallel/pipeline.py
