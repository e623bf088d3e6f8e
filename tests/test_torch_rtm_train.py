"""The port's RTMUAVDet train step (``uavdet_tpu_torch/training/rtm.py``)
against the JAX package's cfg5 step (``bench.py:192-233``, unfolded, rebuilt
here from ``RTMUAVDet.apply``, ``rtm_compute_loss`` and ``optax.adam``), on
the CPU.

Full width at 64 px with ``det_scales=(16, 8)``, batch 2, float32, from one
flax init (its norms perturbed as in tests/test_torch_rtm.py) taken to the
port by ``utils.weights``: 3 Adam updates at lr 1e-4 on uint8 frames, with
dropout neutralized on both sides (flax's ``nn.Dropout`` replaced by an
identity through ``monkeypatch``, the port's p set to 0). The losses to
rtol 1e-4. Adam's moments after the third update (its running means of the
gradients and of their squares, over all three steps) to 1e-3 of their
tensor's largest value (2.7e-4 measured here), but for the two
``group_norm_in`` biases: they feed only MDyConvs whose base BatchNorm, in
train mode, takes any constant off again, so their gradient is zero but
for float noise (about 2e-6, where other gradients reach 1e3), and both
sides are held to keep it there. Every parameter and running statistic as in
tests/test_torch_train_dysoem.py: its change to rtol 1e-3 of the largest
change of its tensor, or two float32 ulps of its largest value where a
change is that small; and to what Adam makes of the gradients' float noise
where that is larger. Adam divides each element's step by that element's
own gradient scale, so at step t a gradient error d moves the element by up
to lr d / |g_t| (the first step is lr times the sign of g_1): an element
whose gradient is near the noise floor at some step takes a step of noise
there, up to lr either way on each side (the two GroupNorm biases above
take one at every step, and are held to Adam's bound, 3 lr, alone). The
first step's gradients agree to about 2e-5 of their tensor's largest
gradient G_t; an element is allowed the sum over the steps of
lr min(2, 1e-4 G_t / |g_t|), five times that, with JAX's g_t, where that
is more than the tolerance above. The gradients are heavy-tailed (a
tensor's median is about a tenth of its largest), and the median
element's allowance stays below 1 % of the 3 lr its updates move it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen

from tests.test_torch_rtm import _NoDropout, perturbed
from tests.test_torch_train_step import one_torch_thread  # noqa: F401
from uavdet_tpu.inference import preprocess as jax_preprocess
from uavdet_tpu.models import rtm_uav_det as jrtm
from uavdet_tpu_torch import kernels
from uavdet_tpu_torch.models import rtm_uav_det as trtm
from uavdet_tpu_torch.training.rtm import make_rtm_train_step, rtm_optimizer
from uavdet_tpu_torch.utils.weights import (load_flax_variables,
                                            rtm_state_dict_from_flax)

SIZE, SCALES, BATCH, STEPS, LR = 64, (16, 8), 2, 3, 1e-4


def batches(rng):
    out = []
    for _ in range(STEPS):
        images = rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
        lo = rng.uniform(0, 40, (BATCH, 1, 2))
        t = np.concatenate([lo, lo + rng.uniform(6, 24, (BATCH, 1, 2))], -1)
        out.append((images, t.astype(np.float32)))
    return out


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(9)
    data = batches(rng)
    jm = jrtm.RTMUAVDet(anchors=trtm.RTM_ANCHORS, det_scales=SCALES)
    v0 = perturbed(jm.init({"params": jax.random.key(9)},
                           jnp.zeros((1, SIZE, SIZE, 3))), 9)
    tx = optax.adam(LR)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(linen, "Dropout", _NoDropout)

        @jax.jit
        def step(params, stats, opt_state, images, targets):
            def loss_fn(p):
                x = jax_preprocess(images, SIZE, jnp.float32)
                outs, mut = jm.apply({"params": p, "batch_stats": stats}, x,
                                     train=True, mutable=["batch_stats"])
                return jrtm.rtm_compute_loss(outs, targets, SIZE,
                                             SCALES), mut["batch_stats"]

            (loss, stats), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params)
            updates, opt_state = tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), stats, opt_state, \
                loss, grads

        params, stats = v0["params"], v0["batch_stats"]
        opt_state = tx.init(params)
        j_losses, j_grads = [], []
        for images, t in data:
            params, stats, opt_state, loss, grads = step(
                params, stats, opt_state, jnp.asarray(images),
                jnp.asarray(t))
            j_losses.append(float(loss))
            j_grads.append(rtm_state_dict_from_flax({"params": grads}))
    want = rtm_state_dict_from_flax({"params": params, "batch_stats": stats})
    adam = opt_state[0]
    moments = {name: rtm_state_dict_from_flax({"params": tree})
               for name, tree in (("exp_avg", adam.mu),
                                  ("exp_avg_sq", adam.nu))}

    model = trtm.RTMUAVDet(trtm.RTM_ANCHORS, det_scales=SCALES)
    load_flax_variables(model, v0)
    for m in model.modules():
        if isinstance(m, trtm.Dropout):
            m.p = 0.0
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    train_step = make_rtm_train_step(model, rtm_optimizer(model), SIZE,
                                     SCALES, torch.float32)
    kernels.reset_launch_counts()
    t_losses = [float(train_step(torch.from_numpy(images),
                                 torch.from_numpy(t)))
                for images, t in data]
    optimizer = train_step.state.optimizer
    got_moments = {name: {k: optimizer.state[p][name].numpy()
                          for k, p in model.named_parameters()}
                   for name in moments}
    return dict(j=np.asarray(j_losses), t=np.asarray(t_losses), want=want,
                got=model.state_dict(), initial=initial,
                state=train_step.state, launches=kernels.launch_counts(),
                moments=moments, got_moments=got_moments, grads=j_grads)


def test_rtm_losses_match_jax(runs):
    np.testing.assert_allclose(runs["t"], runs["j"], rtol=1e-4)
    assert np.isfinite(runs["t"]).all()
    assert (runs["state"].step, runs["state"].scheduler.last_epoch) == (
        STEPS, STEPS)
    assert set(runs["launches"].values()) == {0}


NOISE_ONLY = ("neck.encoder_x1.group_norm_in.bias",
              "neck.encoder_x2.group_norm_in.bias")


def test_rtm_adam_moments_match_jax(runs):
    for name, want in runs["moments"].items():
        got = runs["got_moments"][name]
        assert set(got) == set(want)
        for k, w in want.items():
            w = np.asarray(w)
            if k in NOISE_ONLY:
                floor = 1e-5 if name == "exp_avg" else 1e-10
                assert np.abs(w).max() < floor and \
                    np.abs(got[k]).max() < floor, (name, k)
                continue
            np.testing.assert_allclose(got[k], w, rtol=0,
                                       atol=1e-3 * np.abs(w).max(),
                                       err_msg=f"{name} {k}")


def test_rtm_final_state_matches_jax(runs):
    init, got, want = runs["initial"], runs["got"], runs["want"]
    assert set(want) == set(got)
    moved, allowances = 0, []
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        d_want = np.asarray(w, np.float64) - init[k].double().numpy()
        d_got = got[k].double().numpy() - init[k].double().numpy()
        scale = np.abs(d_want).max()
        moved += scale > 0
        ulp = np.spacing(np.abs(init[k].numpy()).max())
        atol = 1e-3 * scale + 2 * ulp
        if k in NOISE_ONLY:   # noise at every step: Adam's bound alone
            for d in (d_got, d_want):
                assert np.abs(d).max() <= STEPS * LR * 1.001, k
            continue
        if k in runs["grads"][0]:   # a parameter: Adam's noise, per step
            noise = 0.0
            for grads in runs["grads"]:
                g = np.abs(np.asarray(grads[k], np.float64))
                noise = noise + LR * np.minimum(
                    2.0, 1e-4 * g.max() / np.maximum(g, 1e-30))
            allowances.append(noise.ravel())
            atol = np.maximum(atol, noise)
        err = np.abs(d_got - d_want) - (atol + 1e-3 * np.abs(d_want))
        assert (err <= 0).all(), (k, float(err.max()), int((err > 0).sum()))
    assert moved > 0.9 * len(want) // 2
    # the allowance for noise covers a small part of the parameters only
    # the typical parameter is held to 1 % of the 3 lr its updates move it
    assert np.median(np.concatenate(allowances)) < 0.01 * STEPS * LR


def test_rtm_trains_after_serving():
    """A model served first (``make_rtm_detector`` runs in inference mode,
    and fills the neck's cached upsampling matrix at a new shape) then
    trains: the cache holds no inference tensor."""
    from uavdet_tpu_torch.inference import make_rtm_detector
    from uavdet_tpu_torch.utils.seeding import seeded_rtm_model
    size = 48   # a shape no other test of the module resizes at
    model = seeded_rtm_model(0, size, "cpu")
    scales = trtm.rtm_det_scales(size)
    images = torch.randint(0, 256, (1, size, size, 3), dtype=torch.uint8)
    make_rtm_detector(model, size, scales, pre_nms_topk=32)(images)
    step = make_rtm_train_step(model, rtm_optimizer(model), size, scales)
    assert np.isfinite(float(step(images, torch.tensor([[[4.0, 6, 30,
                                                          40]]]))))
