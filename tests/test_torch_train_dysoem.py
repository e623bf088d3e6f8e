"""The port's train step on a DySOEM_SimFPN against
``uavdet_tpu.training.make_train_step``, on the CPU.

Full width (conf/model/dy-soem_fpn.yaml) at 64 px, batch 2, float32, from
one flax init taken to the port by ``utils/weights.py``: 4 microbatches with
grad_batches 2, so two SGD updates. The SOEMs train through the grouped conv
in both packages (no kernel has a backward), with the head strides taken
from the feature shapes (2, 4, 8). The model is smooth (SiLU, no LeakyReLU
whose derivative flips), so the whole run is held as tightly as the first
steps of the DyYOLO trajectory: the losses to rtol 1e-4, every parameter
and running statistic to rtol 1e-3 of the largest change of its tensor,
or two float32 ulps of its largest value where a change is that small (the
attention's weights move by 1e-6: the update rounds to the parameter's
ulps). The SOEM experts' biases feed a BatchNorm in train mode, which
subtracts them again: their gradient is zero up to float noise, so both
sides are held to leave them where they were (to 1e-6).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tests.test_dysoem_training import HP
from tests.test_torch_train_step import (one_torch_thread,  # noqa: F401
                                         painted_batches, port_batch)
from uavdet_tpu.models import DySOEM_SimFPN as JaxDySOEM
from uavdet_tpu.training import build_optimizer as jax_build_optimizer
from uavdet_tpu.training import make_train_step as jax_make_train_step
from uavdet_tpu.utils.datatypes import BatchData as JaxBatch
from uavdet_tpu.utils.datatypes import TrainState as JaxState
from uavdet_tpu_torch.models import DySOEM_SimFPN
from uavdet_tpu_torch.training import (build_optimizer, init_state,
                                       make_eval_step, make_train_step)
from uavdet_tpu_torch.utils.weights import (dysoem_state_dict_from_flax,
                                            load_flax_variables)

INPUT, BATCH, N_MICRO, ACCUM = 64, 2, 4, 2


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(5)
    jm = JaxDySOEM()
    v0 = jm.init(jax.random.key(3), jnp.zeros((BATCH, INPUT, INPUT, 3)),
                 train=False)
    batches = painted_batches(rng, N_MICRO + 1)
    tx = jax_build_optimizer(HP, grad_batches=ACCUM)
    state = JaxState(params=v0["params"], batch_stats=v0["batch_stats"],
                     opt_state=tx.init(v0["params"]),
                     step=jnp.zeros((), jnp.int32))
    step_fn = jax_make_train_step(jm, tx, HP, INPUT)
    j_losses = []
    for b in batches[:N_MICRO]:
        state, m = step_fn(state, JaxBatch(*(jnp.asarray(a) for a in b)))
        j_losses.append(float(m["loss"]))
    want = dysoem_state_dict_from_flax(
        {"params": state.params, "batch_stats": state.batch_stats})

    model = DySOEM_SimFPN()
    load_flax_variables(model, v0)
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    optimizer, scheduler = build_optimizer(model.parameters(), HP)
    pstate = init_state(model, optimizer, scheduler)
    step = make_train_step(model, HP, INPUT, grad_batches=ACCUM)
    t_losses = [float(step(pstate, port_batch(*b))["loss"])
                for b in batches[:N_MICRO]]
    val = make_eval_step(model, HP, INPUT)(port_batch(*batches[-1]))
    return dict(j=np.asarray(j_losses), t=np.asarray(t_losses), want=want,
                got=model.state_dict(), initial=initial, state=pstate,
                val=val)


def test_dysoem_losses_match_jax(runs):
    np.testing.assert_allclose(runs["t"], runs["j"], rtol=1e-4)
    assert (runs["state"].step, runs["state"].mini_step) == (2, 0)
    assert all(torch.isfinite(v) for v in runs["val"].values())


def test_dysoem_final_state_matches_jax(runs):
    init, got, want = runs["initial"], runs["got"], runs["want"]
    assert set(want) == set(got)
    moved = 0
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith("experts.bias"):
            for side in (got[k], torch.from_numpy(np.array(w))):
                assert float((side - init[k]).abs().max()) < 1e-6, k
            continue
        d_want = np.asarray(w, np.float64) - init[k].double().numpy()
        d_got = got[k].double().numpy() - init[k].double().numpy()
        scale = np.abs(d_want).max()
        moved += scale > 0
        ulp = np.spacing(np.abs(init[k].numpy()).max())
        np.testing.assert_allclose(d_got, d_want, rtol=1e-3,
                                   atol=1e-3 * scale + 2 * ulp, err_msg=k)
    assert moved > 0.9 * len(want) // 2
