"""The port's RTMUAVDet (``uavdet_tpu_torch/models/rtm_uav_det.py``) against
``uavdet_tpu.models.rtm_uav_det``, on the CPU, in float32.

Weights come from one flax init per block, with the BatchNorm and GroupNorm
affines and the running statistics perturbed so that eval mode does real
work, taken to the port by ``utils.weights.rtm_state_dict_from_flax``;
inputs are drawn from a numpy seed. Every block (MDyConv at k = 1, 3 and 5,
MDyCSPModule, MDyEncoder, MFDFEncoderModule, RTMHead), then the whole
RTMUAVDet at 64 px with ``det_scales=(16, 8)`` as in tests/test_rtm.py, in
eval mode: outputs to rtol 1e-4. Train mode with dropout neutralized on
both sides (flax's ``nn.Dropout`` replaced by an identity through
``monkeypatch``, the port's p set to 0): outputs and the updated running
statistics. The port's dropout alone: the kept fraction, the 1 / (1 - p)
scale, the same mask from the same seed. The loss:
``filter_high_iou_bboxes`` on tests/test_rtm.py's case, on ties and on an
empty overlap; ``rtm_compute_loss`` to rtol 1e-5 and its gradients with
respect to the heads' outputs to 1e-4 against ``jax.value_and_grad``. The
detector: ``make_rtm_detector`` against the JAX package's cfg4 detect
(``bench.py:158-186``, rebuilt here from ``RTMUAVDet.apply``,
``lax.top_k`` and ``uavdet_tpu.ops.nms.nms``): ``valid`` equal, scores to
rtol 1e-4, boxes to 1e-4 px plus 1e-5 of their size.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen

from tests.test_torch_train_step import one_torch_thread  # noqa: F401
from uavdet_tpu.models import rtm_uav_det as jrtm
from uavdet_tpu.ops.nms import nms as jax_nms
from uavdet_tpu_torch import kernels
from uavdet_tpu_torch.inference import make_rtm_detector
from uavdet_tpu_torch.models import build_model
from uavdet_tpu_torch.models import rtm_uav_det as trtm
from uavdet_tpu_torch.models.registry import DYYOLO
from uavdet_tpu_torch.utils.weights import (load_flax_variables,
                                            rtm_state_dict_from_flax)

ANCHORS = trtm.RTM_ANCHORS
SIZE, SCALES = 64, (16, 8)
RTOL, ATOL = 1e-4, 1e-5


def perturbed(variables, seed):
    """The flax variables with every norm's scale in [0.8, 1.2], its bias
    and running mean around 0 and its running variance in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    flat = flax.traverse_util.flatten_dict(flax.core.unfreeze(variables))
    for key, a in flat.items():
        shape = np.shape(a)
        if key[-1] == "scale":
            flat[key] = jnp.asarray(rng.uniform(0.8, 1.2, shape), jnp.float32)
        elif key[-1] == "mean" or (key[-1] == "bias" and (
                "BatchNorm" in key[-2] or key[-2].startswith("group_norm"))):
            flat[key] = jnp.asarray(rng.normal(0, 0.1, shape), jnp.float32)
        elif key[-1] == "var":
            flat[key] = jnp.asarray(rng.uniform(0.5, 1.5, shape), jnp.float32)
    return flax.traverse_util.unflatten_dict(flat)


def port_of(module, variables, block):
    sd = rtm_state_dict_from_flax(variables, block)
    module.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in sd.items()}, strict=True)
    return module.eval()


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(a), (0, 3, 1, 2))))


def assert_nhwc_close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=rtol, atol=atol)


def assert_outs_close(got, want, rtol=RTOL, atol=ATOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for field in ("bbox", "obj"):
            gt, wt = getattr(g, field), np.asarray(getattr(w, field))
            assert tuple(gt.shape) == wt.shape and gt.dtype == torch.float32
            np.testing.assert_allclose(gt.detach().numpy(), wt, rtol=rtol,
                                       atol=atol * max(1.0, np.abs(wt).max()),
                                       err_msg=field)


def features(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("k,p", [(1, 0), (3, 1), (5, 2)])
def test_mdyconv_matches_jax(k, p):
    rng = np.random.default_rng(k)
    x = features(rng, 2, 9, 11, 12)
    jm = jrtm.MDyConv(16, dy_kernel_size=k, dy_padding=p, dy_channel_size=8)
    v = perturbed(jm.init(jax.random.key(k), jnp.asarray(x)), k)
    tm = port_of(trtm.MDyConv(12, 16, k, p, 8), v, "MDyConv")
    with torch.no_grad():
        assert_nhwc_close(tm(nchw(x)), jm.apply(v, jnp.asarray(x)))


def test_spatial_dyconv_is_one_grouped_conv_per_sample():
    """Sample b's every channel convolved with kernel_w[b] alone."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(features(rng, 3, 5, 7, 6))
    kw = torch.from_numpy(features(rng, 3, 3, 3))
    got = trtm.spatial_dyconv(x, kw, 1)
    for b in range(3):
        for c in range(5):
            want = torch.nn.functional.conv2d(x[b, c][None, None],
                                              kw[b][None, None], padding=1)
            torch.testing.assert_close(got[b, c], want[0, 0], rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("dy", [None, 24])
def test_mdycsp_matches_jax(dy):
    rng = np.random.default_rng(1)
    x = features(rng, 2, 16, 14, 8)
    jm = jrtm.MDyCSPModule(16, dy_channel_size=dy)
    v = perturbed(jm.init(jax.random.key(1), jnp.asarray(x)), 1)
    tm = port_of(trtm.MDyCSPModule(8, 16, dy_channel_size=dy), v,
                 "MDyCSPModule")
    with torch.no_grad():
        assert_nhwc_close(tm(nchw(x)), jm.apply(v, jnp.asarray(x)))


def test_mdyencoder_matches_jax():
    rng = np.random.default_rng(2)
    x = features(rng, 2, 10, 12, 18)
    jm = jrtm.MDyEncoder(12)
    v = perturbed(jm.init(jax.random.key(2), jnp.asarray(x)), 2)
    tm = port_of(trtm.MDyEncoder(18, 12), v, "MDyEncoder")
    with torch.no_grad():
        assert_nhwc_close(tm(nchw(x)), jm.apply(v, jnp.asarray(x)))


def test_mfdf_matches_jax():
    rng = np.random.default_rng(3)
    x1, x2 = features(rng, 2, 16, 16, 12), features(rng, 2, 8, 8, 24)
    jm = jrtm.MFDFEncoderModule(12, 24)
    v = perturbed(jm.init(jax.random.key(3), jnp.asarray(x1),
                          jnp.asarray(x2)), 3)
    tm = port_of(trtm.MFDFEncoderModule(12, 24), v, "MFDFEncoderModule")
    want = jm.apply(v, jnp.asarray(x1), jnp.asarray(x2))
    with torch.no_grad():
        got = tm(nchw(x1), nchw(x2))
    for g, w in zip(got, want):
        assert_nhwc_close(g, w)


def test_head_matches_jax():
    rng = np.random.default_rng(4)
    f1, f2 = features(rng, 2, 16, 16, 12), features(rng, 2, 8, 8, 24)
    jm = jrtm.RTMHead(ANCHORS, SCALES)
    v = jm.init(jax.random.key(4), jnp.asarray(f1), jnp.asarray(f2))
    tm = port_of(trtm.RTMHead(ANCHORS, (12, 24)), v, "RTMHead")
    with torch.no_grad():
        assert_outs_close(tm([nchw(f1), nchw(f2)]),
                          jm.apply(v, jnp.asarray(f1), jnp.asarray(f2)))


@pytest.fixture(scope="module")
def rtm():
    """The flax RTMUAVDet at 64 px, its perturbed variables, the port's
    model loaded from them, and a batch of frames."""
    rng = np.random.default_rng(5)
    x = rng.uniform(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    jm = jrtm.RTMUAVDet(anchors=ANCHORS, det_scales=SCALES)
    v = perturbed(jm.init({"params": jax.random.key(5)}, jnp.asarray(x)), 5)
    tm = trtm.RTMUAVDet(ANCHORS, det_scales=SCALES)
    load_flax_variables(tm, v)
    return jm, v, tm.eval(), x


def test_rtm_eval_matches_jax(rtm):
    jm, v, tm, x = rtm
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert [tuple(o.obj.shape) for o in got] == [(2, 3, 16, 16, 1),
                                                 (2, 3, 8, 8, 1)]
    assert sum(p.numel() for p in tm.parameters()) == sum(
        a.size for a in jax.tree.leaves(v["params"]))
    assert_outs_close(got, jm.apply(v, jnp.asarray(x)))


class _NoDropout(linen.Module):
    rate: float = 0.0
    deterministic: bool | None = None

    def __call__(self, x, deterministic=None, rng=None):
        return x


def test_rtm_train_mode_matches_jax(rtm, monkeypatch):
    """Train mode, dropout neutralized on both sides: the outputs, and the
    running statistics after the update (flax momenta 0.97 and, in the
    MDyConvs' base convs, 0.9; the biased batch variance)."""
    jm, v, _, x = rtm
    monkeypatch.setattr(linen, "Dropout", _NoDropout)
    want, mut = jm.apply(v, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    tm = trtm.RTMUAVDet(ANCHORS, det_scales=SCALES)
    load_flax_variables(tm, v)
    for m in tm.modules():
        if isinstance(m, trtm.Dropout):
            m.p = 0.0
    tm.train()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert_outs_close(got, want)
    stats = rtm_state_dict_from_flax({"params": v["params"],
                                      "batch_stats": mut["batch_stats"]})
    sd = tm.state_dict()
    n = 0
    for key, w in stats.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[key].numpy(), w, rtol=RTOL,
                                       atol=ATOL, err_msg=key)
            n += 1
    assert n == 2 * 19   # the model's BatchNorms


def test_dropout_mask():
    """The kept fraction 1 - p, the kept values scaled by 1 / (1 - p), one
    seed giving one mask, and the identity in eval mode."""
    d = trtm.Dropout(0.2).train()
    x = torch.ones(200_000)
    y = d(x, torch.Generator().manual_seed(3))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.8) < 0.005
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1.25))
    torch.testing.assert_close(y, d(x, torch.Generator().manual_seed(3)),
                               rtol=0, atol=0)
    assert not torch.equal(y, d(x, torch.Generator().manual_seed(4)))
    assert d.eval()(x) is x


def test_filter_high_iou_bboxes():
    """tests/test_rtm.py's case, a tie (the first prediction wins, as in
    ``jnp.argmax``) and a target that overlaps nothing."""
    p = [[0, 0, 10, 10], [20, 20, 30, 30], [100, 100, 110, 110.0],
         [0, 0, 10, 10]]
    s = [0.9, 0.8, 0.7, 0.6]
    t = [[1, 1, 11, 11.0], [500, 500, 510, 510.0], [20, 20, 30, 30.0]]
    want = jrtm.filter_high_iou_bboxes(jnp.asarray(p), jnp.asarray(s),
                                       jnp.asarray(t))
    got = trtm.filter_high_iou_bboxes(torch.tensor(p), torch.tensor(s),
                                      torch.tensor(t))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    fb, fo, t_obj = got
    assert fb[0].tolist() == [0, 0, 10, 10]
    assert float(fo[0]) == pytest.approx(0.9)
    assert fb[1].tolist() == p[0]     # no overlap: every IoU 0, the first
    np.testing.assert_array_equal(t_obj.numpy(), [1, 1, 0, 1])


def loss_inputs(seed, batch=2, m=3):
    """Head outputs of the 64 px model's shapes and target boxes."""
    rng = np.random.default_rng(seed)
    outs = []
    for s in SCALES:
        cxy = rng.uniform(0, s, (batch, 3, s, s, 2))
        wh = rng.uniform(0.5, 6, (batch, 3, s, s, 2))
        outs.append((np.concatenate([cxy, wh], -1).astype(np.float32),
                     rng.uniform(0.01, 0.99, (batch, 3, s, s, 1))
                     .astype(np.float32)))
    lo = rng.uniform(0, 40, (batch, m, 2))
    t = np.concatenate([lo, lo + rng.uniform(4, 24, (batch, m, 2))], -1)
    return outs, t.astype(np.float32)


def test_rtm_loss_and_gradients_match_jax():
    outs, t = loss_inputs(6)

    def jax_loss(heads):
        res = [jrtm.DetectionResults(bbox=b, obj=o) for b, o in heads]
        return jrtm.rtm_compute_loss(res, jnp.asarray(t), SIZE, SCALES)

    val, grads = jax.value_and_grad(jax_loss)(
        [(jnp.asarray(b), jnp.asarray(o)) for b, o in outs])
    heads = [(torch.tensor(b, requires_grad=True),
              torch.tensor(o, requires_grad=True)) for b, o in outs]
    loss = trtm.rtm_compute_loss(
        [trtm.DetectionResults(bbox=b, obj=o) for b, o in heads],
        torch.from_numpy(t), SIZE, SCALES)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(val), rtol=1e-5)
    for (b, o), (gb, go) in zip(heads, grads):
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(gb),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(o.grad.numpy(), np.asarray(go),
                                   rtol=1e-4, atol=1e-4)
    assert float(max(b.grad.abs().max() for b, _ in heads)) > 0


def test_rtm_loss_of_the_model_matches_jax(rtm):
    """The loss of the model's own outputs (tests/test_rtm.py's targets)."""
    jm, v, tm, x = rtm
    t = np.tile(np.asarray([[10, 10, 30, 30.0]], np.float32), (2, 1, 1))
    want = jrtm.rtm_compute_loss(jm.apply(v, jnp.asarray(x)),
                                 jnp.asarray(t), SIZE, SCALES)
    with torch.no_grad():
        got = trtm.rtm_compute_loss(tm(torch.from_numpy(x)),
                                    torch.from_numpy(t), SIZE, SCALES)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def jax_detect(jm, v, images, topk, max_det):
    """``bench.py:158-186`` unfolded, in float32, keeping the boxes."""
    from uavdet_tpu.inference import preprocess
    x = preprocess(jnp.asarray(images), SIZE, jnp.float32)
    outs = jm.apply(v, x, train=False)
    b = images.shape[0]
    boxes, scores = [], []
    for h, o in enumerate(outs):
        stride = SIZE // SCALES[h]
        bb = o.bbox.reshape(b, -1, 4) * stride
        boxes.append(jnp.stack(
            [bb[..., 0] - bb[..., 2] / 2, bb[..., 1] - bb[..., 3] / 2,
             bb[..., 0] + bb[..., 2] / 2, bb[..., 1] + bb[..., 3] / 2],
            axis=-1))
        scores.append(o.obj.reshape(b, -1))
    bx, sc = jnp.concatenate(boxes, 1), jnp.concatenate(scores, 1)

    def per_image(bi, si):
        top_s, top_i = jax.lax.top_k(si, topk)
        keep, _, _ = jax_nms(bi[top_i], top_s, 0.5, max_det)
        safe = jnp.maximum(keep, 0)
        return (bi[top_i][safe] * (keep >= 0)[:, None],
                top_s[safe] * (keep >= 0), keep >= 0)

    return [np.asarray(a) for a in jax.vmap(per_image)(bx, sc)]


def test_rtm_detector_matches_bench_detect(rtm):
    jm, v, tm, _ = rtm
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (3, SIZE, SIZE, 3), dtype=np.uint8)
    want_b, want_s, want_v = jax_detect(jm, v, images, 96, 40)
    kernels.reset_launch_counts()
    d = make_rtm_detector(tm, SIZE, SCALES, pre_nms_topk=96, max_det=40,
                          compute_dtype=torch.float32)(images)
    assert set(kernels.launch_counts().values()) == {0}
    assert d.boxes.shape == (3, 40, 4) and d.scores.shape == (3, 40)
    np.testing.assert_array_equal(d.valid.numpy(), want_v)
    assert 0 < int(want_v.sum()) < want_v.size
    np.testing.assert_allclose(d.scores.numpy(), want_s, rtol=1e-4,
                               atol=1e-7)
    # the forward's float error scales with a box's size (a box of tens of
    # pixels differs by up to 7e-4 px): 1e-4 px plus 1e-5 of the box
    np.testing.assert_allclose(d.boxes.numpy(), want_b, rtol=1e-5,
                               atol=1e-4)
    assert (d.boxes[~d.valid] == 0).all() and (d.scores[~d.valid] == 0).all()


def test_rtm_is_not_dispatchable():
    """As in the JAX package (tests/test_models.py): ``build_model`` does
    not take it, and ``models`` does not export it."""
    import uavdet_tpu_torch.models as models
    with pytest.raises(ValueError):
        build_model("RTMUAVDet", DYYOLO, device="cpu")
    assert not hasattr(models, "RTMUAVDet")
