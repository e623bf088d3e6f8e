"""The port's train step (``uavdet_tpu_torch/training/steps.py``) against
``uavdet_tpu.training.make_train_step``, on the CPU.

A tiny DyYOLO at 64 px, float32, from the same weights (a flax init taken
to the port through ``utils/weights.py``): 20 microbatches, grad_batches 2,
SGD with momentum 0.78, BatchNorm in train mode, the ``col0`` loss. The
tolerances are those of tests/test_torch_import.py's trajectory test and
for the same reason: this training run is chaotic (LeakyReLU derivatives
flip on activations within float noise of 0, and momentum amplifies the
flips over 10 updates), so steps 0 to 3 are held tight, the rest of the
trajectory within the same-framework chaos floor measured there (7.6 %),
and the final parameters by the norm of their change (a convention bug
moves it 2x to 10x) and its direction within the chaos floor.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tests.test_entry_points import TINY
from tests.test_torch_model import STEM_CFG
from uavdet_tpu.models import DyYOLO as JaxDyYOLO
from uavdet_tpu.training import build_optimizer as jax_build_optimizer
from uavdet_tpu.training import make_train_step as jax_make_train_step
from uavdet_tpu.utils.datatypes import BatchData as JaxBatch
from uavdet_tpu.utils.datatypes import TrainState as JaxState
from uavdet_tpu_torch.models import DyYOLO
from uavdet_tpu_torch.models.layers import DyConvModule
from uavdet_tpu_torch.ops import dyconv as port_dyconv
from uavdet_tpu_torch.ops import nms as port_nms
from uavdet_tpu_torch.ops import stem as port_stem
from uavdet_tpu_torch.training import (build_optimizer, init_state,
                                       make_eval_step, make_train_step)
from uavdet_tpu_torch.utils.datatypes import BatchData
from uavdet_tpu_torch.utils.seeding import init_weights
from uavdet_tpu_torch.utils.weights import (load_flax_variables,
                                            state_dict_from_flax)

INPUT, BATCH, N_MICRO, ACCUM = 64, 2, 20, 2
CFG = tuple(tuple(t) for t in TINY)


class HP:
    anchors = [[[40, 30], [60, 46], [54, 36]],
               [[18, 14], [24, 18], [30, 12]],
               [[6, 5], [10, 6], [13, 8]]]
    head_scales = [16, 8, 4]
    lr = 0.01
    lr_scheduler = False
    bbox_loss_fn = "mse"
    iou_mode = "col0"
    attn_temperature = 30.0
    layer_config = CFG

    class loss_balancing:
        obj_scales_w = [0.5, 1.0, 2.0]
        bbox_w = 4.0
        objectness_w = 1.0
        no_obj_w = 4.0

    class optim:
        name = "SGD"
        momentum = 0.78


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module: at these sizes torch's CPU
    threads cost more than they give (a tiny DyYOLO's step took 0.08 s on
    one thread and 0.6 to 6 s on eight in this suite's sandbox), and the
    suite runs in several worker processes already."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def painted_batches(rng, n, batch=BATCH, size=INPUT, boxes_per=2):
    """n batches of uniform noise frames with ``boxes_per`` random boxes
    each: (images (B, S, S, 3), boxes (B, N, 4) normalized, mask)."""
    out = []
    for _ in range(n):
        imgs = rng.uniform(size=(batch, size, size, 3)).astype(np.float32)
        wh = rng.uniform(size / 8, size * 0.45, size=(batch, boxes_per, 2))
        cxy = rng.uniform(wh / 2 + 1, size - wh / 2 - 1)
        boxes = (np.concatenate([cxy - wh / 2, cxy + wh / 2], -1)
                 / size).astype(np.float32)
        out.append((imgs, boxes, np.ones((batch, boxes_per), bool)))
    return out


def port_batch(imgs, boxes, mask) -> BatchData:
    return BatchData(*(torch.from_numpy(a) for a in (imgs, boxes, mask)))


@pytest.fixture(scope="module")
def trajectories():
    """Both trajectories from one flax init, run once for the module."""
    rng = np.random.default_rng(211)
    jm = JaxDyYOLO(layer_config=CFG, attn_temperature=30.0)
    v0 = jm.init(jax.random.key(7), jnp.zeros((BATCH, INPUT, INPUT, 3)),
                 train=False)
    batches = painted_batches(rng, N_MICRO)

    tx = jax_build_optimizer(HP, grad_batches=ACCUM)
    state = JaxState(params=v0["params"], batch_stats=v0["batch_stats"],
                     opt_state=tx.init(v0["params"]),
                     step=jnp.zeros((), jnp.int32))
    step_fn = jax_make_train_step(jm, tx, HP, INPUT)
    j_losses = []
    for imgs, boxes, mask in batches:
        state, m = step_fn(state, JaxBatch(*(jnp.asarray(a) for a in
                                             (imgs, boxes, mask))))
        j_losses.append(float(m["loss"]))
        if len(j_losses) == 1:
            j_first = state_dict_from_flax(
                {"params": state.params, "batch_stats": state.batch_stats},
                CFG)
    j_final = state_dict_from_flax(
        {"params": state.params, "batch_stats": state.batch_stats}, CFG)

    model = DyYOLO(CFG, attn_temperature=30.0)
    load_flax_variables(model, v0)
    initial = {k: v.detach().clone() for k, v in model.state_dict().items()}
    optimizer, scheduler = build_optimizer(model.parameters(), HP)
    pstate = init_state(model, optimizer, scheduler)
    train_step = make_train_step(model, HP, INPUT, grad_batches=ACCUM)
    t_losses = []
    for b in batches:
        t_losses.append(float(train_step(pstate, port_batch(*b))["loss"]))
        if len(t_losses) == 1:
            t_first = {k: v.clone() for k, v in model.state_dict().items()}
    return dict(j_losses=np.asarray(j_losses), t_losses=np.asarray(t_losses),
                initial=initial, got=model.state_dict(), want=j_final,
                state=pstate, t_first=t_first, j_first=j_first)


def test_trajectory_first_steps_tight(trajectories):
    """Steps 0 to 3: the loss of the same weights, then of the first two
    updates."""
    t, j = trajectories["t_losses"], trajectories["j_losses"]
    assert t[-1] < 0.9 * t[0]     # training moves
    np.testing.assert_allclose(t[:4], j[:4], rtol=1e-4)


def test_first_microbatch_batchnorm_statistics(trajectories):
    """After the first microbatch (no update yet, the same weights) the
    running statistics of every BatchNorm equal flax's: the variance's
    update takes the biased batch variance (torch's unbiased one would be
    off by 1/31 of the batch term at the 4 x 4 x 2 map)."""
    t, j = trajectories["t_first"], trajectories["j_first"]
    for k, w in j.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t[k].numpy(), np.asarray(w),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def test_trajectory_whole_within_chaos_floor(trajectories):
    t, j = trajectories["t_losses"], trajectories["j_losses"]
    assert np.abs((t - j) / j).max() < 0.2
    state = trajectories["state"]
    assert (state.step, state.mini_step) == (N_MICRO // ACCUM, 0)
    assert state.scheduler.last_epoch == N_MICRO // ACCUM


def _delta(trajectories, keep):
    """(relative L2 of the port's change against JAX's, ratio of their
    norms) over the state_dict entries ``keep`` selects."""
    init, got, want = (trajectories[k] for k in ("initial", "got", "want"))
    err2 = got2 = want2 = 0.0
    for k, w in want.items():
        if not keep(k):
            continue
        p0 = init[k].double().numpy()
        dg = got[k].double().numpy() - p0
        dw = np.asarray(w, np.float64) - p0
        err2 += float(((dg - dw) ** 2).sum())
        got2 += float((dg ** 2).sum())
        want2 += float((dw ** 2).sum())
    return (err2 / want2) ** 0.5, (got2 / want2) ** 0.5


@pytest.mark.parametrize("which", ["params", "running_mean", "running_var"])
def test_trajectory_final_state_deltas(trajectories, which):
    """The change of the parameters and of the BatchNorm running
    statistics over the 20 microbatches: the norm preserved (a momentum
    convention bug shows ~4.5x, a missed accumulation ~2x, BN's momentum
    swapped ~9x, torch's unbiased running variance +3 % per update at the
    4x4x2 map), the direction within the chaos floor (0.276 measured, x2)."""
    if which == "params":
        def keep(k):
            return not k.endswith(("running_mean", "running_var",
                                   "num_batches_tracked"))
        ratio_tol = 0.1
    else:
        def keep(k):
            return k.endswith(which)
        ratio_tol = 0.15
    rel_l2, ratio = _delta(trajectories, keep)
    assert abs(ratio - 1) < ratio_tol, ratio
    assert rel_l2 < 0.6, rel_l2


def _hooked_dtypes(model):
    """Output dtypes of every Conv2d and DyConvModule, by forward hooks."""
    seen, handles = [], []
    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, DyConvModule)):
            handles.append(m.register_forward_hook(
                lambda mod, args, out: seen.append(out.dtype)))
    return seen, handles


@pytest.mark.parametrize("compute_dtype", [torch.bfloat16, torch.float32])
def test_train_step_convs_run_in_compute_dtype(rng, compute_dtype):
    """Under autocast every conv of a train step runs in bf16, with float32
    parameters and a float32 loss. Without it the model computes in its
    parameters' float32 even on bf16 frames (the dtype leak that autocast
    closes)."""
    model = init_weights(DyYOLO(CFG, attn_temperature=30.0), 3)
    optimizer, scheduler = build_optimizer(model.parameters(), HP)
    state = init_state(model, optimizer, scheduler)
    step = make_train_step(model, HP, INPUT, compute_dtype=compute_dtype)
    imgs, boxes, mask = painted_batches(rng, 1)[0]
    batch = port_batch(imgs, boxes, mask)
    batch = batch._replace(image=batch.image.to(torch.bfloat16))
    seen, handles = _hooked_dtypes(model)
    m = step(state, batch)
    for h in handles:
        h.remove()
    # a DyConvModule reads its two attention convs as matrices
    n_dy = sum(isinstance(x, DyConvModule) for x in model.modules())
    n_conv = sum(isinstance(x, torch.nn.Conv2d) for x in model.modules())
    assert len(seen) == n_conv - 2 * n_dy + n_dy
    assert set(seen) == {compute_dtype}
    assert m["loss"].dtype == torch.float32 and torch.isfinite(m["loss"])
    assert all(p.dtype == torch.float32 and p.grad is None
               for p in model.parameters())   # updated and cleared
    assert state.step == 1


@pytest.mark.parametrize("remat", [True, "dots_saveable"])
def test_remat_matches_plain_step(rng, remat):
    """Recomputing the forward in the backward changes neither the update
    nor the BatchNorm running statistics (the recomputation's second
    update is undone)."""
    imgs, boxes, mask = painted_batches(rng, 1)[0]
    states = []
    for r in (False, remat):
        model = init_weights(DyYOLO(CFG, attn_temperature=30.0), 5)
        optimizer, scheduler = build_optimizer(model.parameters(), HP)
        state = init_state(model, optimizer, scheduler)
        make_train_step(model, HP, INPUT, remat=r)(
            state, port_batch(imgs, boxes, mask))
        states.append(model.state_dict())
    for k, v in states[0].items():
        torch.testing.assert_close(states[1][k], v, rtol=1e-5, atol=1e-7,
                                   msg=k)
    with pytest.raises(ValueError, match="no counterpart"):
        make_train_step(model, HP, INPUT, remat="checkpoint_dots")


def test_nan_guard_step_restores_batchnorm(rng):
    """A non-finite loss: no backward and no update, the BatchNorm buffers
    as they were before the step, earlier accumulated gradients kept."""
    model = init_weights(DyYOLO(CFG, attn_temperature=30.0), 4)
    optimizer, scheduler = build_optimizer(model.parameters(), HP)
    state = init_state(model, optimizer, scheduler)
    step = make_train_step(model, HP, INPUT, grad_batches=2, nan_guard=True)
    good, bad = painted_batches(rng, 2)
    step(state, port_batch(*good))
    assert state.mini_step == 1
    grads = [p.grad.clone() for p in model.parameters()]
    buffers = {k: v.clone() for k, v in model.state_dict().items()}
    bad = (np.full_like(bad[0], np.nan), *bad[1:])
    m = step(state, port_batch(*bad))
    assert not torch.isfinite(m["loss"])
    assert (state.step, state.mini_step) == (0, 1)
    for k, v in model.state_dict().items():
        assert torch.equal(v, buffers[k]), k
    for p, g in zip(model.parameters(), grads):
        assert torch.equal(p.grad, g)


def test_train_step_reaches_no_kernel(rng, monkeypatch):
    """A train step runs the plain modules: not the stem's inference path
    (``fused_stem_forward``, no_grad), not the dyconv or NMS ops. Every
    plain version the kernels' wrappers dispatch to on the CPU raises
    here; the detector on the same model reaches them (the control)."""
    def boom(*args, **kwargs):
        raise AssertionError("a kernel's path was reached")

    for mod, name in ((port_stem, "stem_l1_plain"),
                      (port_stem, "stem_l2_plain"),
                      (port_dyconv, "dyconv_plain"),
                      (port_nms, "nms_alive_plain")):
        monkeypatch.setattr(mod, name, boom)
    model = init_weights(DyYOLO(STEM_CFG, attn_temperature=30.0), 6)
    optimizer, scheduler = build_optimizer(model.parameters(), HP)
    state = init_state(model, optimizer, scheduler)
    hp = type("HP2", (HP,), {"anchors": HP.anchors[:2],
                             "loss_balancing": type("LB", (), dict(
                                 obj_scales_w=[1.0, 2.0], bbox_w=4.0,
                                 objectness_w=1.0, no_obj_w=4.0))})
    batch = port_batch(*painted_batches(rng, 1)[0])
    for dtype in (torch.float32, torch.bfloat16):
        m = make_train_step(model, hp, INPUT, compute_dtype=dtype)(state,
                                                                   batch)
        assert torch.isfinite(m["loss"])
        make_eval_step(model, hp, INPUT, compute_dtype=dtype)(batch)
    from uavdet_tpu_torch.inference import make_detector
    with pytest.raises(AssertionError, match="kernel's path"):
        make_detector(model, hp, INPUT, compute_dtype=torch.float32)(
            batch.image)


def test_chip_smoke_tiny_config_is_the_tests():
    """chip_smoke.py's float32 card-vs-CPU steps use this tiny DyYOLO; it
    keeps its own copy (the card imports nothing of the tests)."""
    import chip_smoke
    assert chip_smoke.TINY == CFG
