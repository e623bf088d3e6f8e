"""The port's training ops against the JAX package's, on the CPU: box
geometry (``ops/boxes.py``), decoding (``ops/decode.py``), target encoding
(``ops/targets.py``), the YOLO loss (``ops/losses.py``) and the BatchNorm
update of the port's models.

The same numpy inputs from a seed go through both sides. Tolerances: the
two sides run the same float32 operations in the same order, so targets are
equal and values agree to rtol 1e-5 (the transcendental functions of XLA
and ATen may round differently in the last place); gradients to rtol 1e-4,
since a backward sums those ulps over the cells of a head.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import flax.linen as fnn

from tests.test_targets import ANCHORS as ORACLE_ANCHORS
from tests.test_targets import HEAD_SCALES as ORACLE_SCALES
from tests.test_targets import INPUT as ORACLE_INPUT
from tests.test_targets import _encode_numpy
from tests.test_torch_train_step import one_torch_thread  # noqa: F401
from uavdet_tpu.ops import boxes as jax_boxes
from uavdet_tpu.ops import decode as jax_decode
from uavdet_tpu.ops import losses as jax_losses
from uavdet_tpu.ops import targets as jax_targets
from uavdet_tpu.utils.datatypes import DetectionResults as JaxResults
from uavdet_tpu_torch.models.layers import BatchNorm2d
from uavdet_tpu_torch.ops import boxes, decode, losses, targets
from uavdet_tpu_torch.utils.datatypes import DetectionResults

INPUT = 64
SCALES = (16, 8, 4)
ANCHORS = np.array([[[40, 30], [60, 46], [54, 36]],
                    [[18, 14], [24, 18], [30, 12]],
                    [[6, 5], [10, 6], [13, 8]]], np.float32)
LB = dict(obj_scales_w=(0.5, 1.0, 2.0), bbox_w=4.0, objectness_w=1.0,
          no_obj_w=4.0)


def _random_boxes(rng, b, n, input_size, lo=4, hi=28, p_mask=0.8):
    """(B, N, 4) normalized xyxy boxes inside the frame, and a mask."""
    wh = rng.uniform(lo, hi, size=(b, n, 2))
    cxy = rng.uniform(wh / 2 + 1, input_size - wh / 2 - 1)
    xyxy = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1) / input_size
    return xyxy.astype(np.float32), rng.uniform(size=(b, n)) < p_mask


def _duplicate_cell_boxes(rng, b=3, n=6):
    """Boxes whose centers share cells on every head, of sizes that pick
    different anchors: the later box must win each cell."""
    boxes, mask = _random_boxes(rng, b, n, INPUT)
    centre = rng.uniform(20, 44, size=(b, 1, 2))
    jitter = rng.uniform(-0.4, 0.4, size=(b, n, 2))
    wh = rng.uniform(4, 40, size=(b, n, 2))
    cxy = centre + jitter
    boxes = (np.concatenate([cxy - wh / 2, cxy + wh / 2], -1)
             / INPUT).astype(np.float32)
    mask[:, :4] = True
    return boxes, mask


def test_box_ops_match_jax(rng):
    a = rng.uniform(0, 60, size=(5, 7, 4)).astype(np.float32)
    b = rng.uniform(0, 60, size=(5, 7, 4)).astype(np.float32)
    a[..., 2:] += a[..., :2]
    b[..., 2:] += b[..., :2]
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for fin, fout in (("xyxy", "cxcywh"), ("cxcywh", "xyxy"),
                      ("xywh", "xyxy"), ("xyxy", "xywh"),
                      ("cxcywh", "xywh")):
        np.testing.assert_allclose(
            boxes.box_convert(ta, fin, fout).numpy(),
            np.asarray(jax_boxes.box_convert(jnp.asarray(a), fin, fout)),
            rtol=1e-6)
    for fn in ("box_iou_elementwise", "complete_box_iou"):
        np.testing.assert_allclose(
            getattr(boxes, fn)(ta, tb).numpy(),
            np.asarray(getattr(jax_boxes, fn)(jnp.asarray(a),
                                              jnp.asarray(b))),
            rtol=1e-5, atol=1e-6)
    wh = rng.uniform(0.01, 0.5, size=(9, 2)).astype(np.float32)
    anc = ANCHORS[0] / INPUT
    np.testing.assert_allclose(
        boxes.anchor_iou(torch.from_numpy(wh), torch.from_numpy(anc)).numpy(),
        np.asarray(jax_boxes.anchor_iou(jnp.asarray(wh), jnp.asarray(anc))),
        rtol=1e-6)


def test_complete_box_iou_gradient_detaches_alpha(rng):
    """The gradient of CIoU matches jax.grad with alpha under
    stop_gradient."""
    a = rng.uniform(0, 30, size=(16, 4)).astype(np.float32)
    b = rng.uniform(0, 30, size=(16, 4)).astype(np.float32)
    a[:, 2:] += a[:, :2] + 1
    b[:, 2:] += b[:, :2] + 1
    ta = torch.from_numpy(a).requires_grad_()
    boxes.complete_box_iou(ta, torch.from_numpy(b)).sum().backward()
    want = jax.grad(lambda x: jax_boxes.complete_box_iou(
        x, jnp.asarray(b)).sum())(jnp.asarray(a))
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-7)


@pytest.mark.parametrize("fn", ["mse", "ciou"])
def test_decode_predictions_match_jax(rng, fn):
    p = rng.normal(size=(2, 3, 5, 6, 4)).astype(np.float32)
    anc = ANCHORS[1] / 8.0
    got = decode.decode_predictions(torch.from_numpy(p),
                                    torch.from_numpy(anc), fn)
    want = jax_decode.decode_predictions(jnp.asarray(p), jnp.asarray(anc), fn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    t = np.abs(rng.normal(size=(2, 3, 5, 6, 4))).astype(np.float32)
    np.testing.assert_allclose(
        decode.add_grid_offsets(torch.from_numpy(t)).numpy(),
        np.asarray(jax_decode.add_grid_offsets(jnp.asarray(t))), rtol=1e-6)
    np.testing.assert_allclose(
        decode.normalize_target_wh(torch.from_numpy(t),
                                   torch.from_numpy(anc)).numpy(),
        np.asarray(jax_decode.normalize_target_wh(jnp.asarray(t),
                                                  jnp.asarray(anc))),
        rtol=1e-6)


@pytest.mark.parametrize("case", ["random", "duplicate_cells"])
def test_encode_yolo_targets_equal_jax(rng, case):
    if case == "random":
        bx, mask = _random_boxes(rng, 4, 8, INPUT)
    else:
        bx, mask = _duplicate_cell_boxes(rng)
    got = targets.encode_yolo_targets(torch.from_numpy(bx),
                                      torch.from_numpy(mask), ANCHORS,
                                      SCALES, INPUT)
    want = jax_targets.encode_yolo_targets(jnp.asarray(bx), jnp.asarray(mask),
                                           ANCHORS, SCALES, INPUT)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if case == "duplicate_cells":   # the later box really overwrote some
        written = sum(int((g[..., 0] == 1).sum()) for g in got)
        assert written < int(mask.sum()) * 3


def test_encode_yolo_targets_numpy_oracle(rng):
    """The 640 px configuration against the reference's sequential encoder
    of tests/test_targets.py, per image, boxes in pixels there. The oracle
    computes in float64: offsets of up to 80 cells round at 8e-6 in
    float32, hence that file's own tolerance."""
    bx, mask = _random_boxes(rng, 3, 8, ORACLE_INPUT, lo=10, hi=300)
    bx[:, 5] = bx[:, 2]                     # a duplicate box
    got = targets.encode_yolo_targets(torch.from_numpy(bx),
                                      torch.from_numpy(mask), ORACLE_ANCHORS,
                                      ORACLE_SCALES, ORACLE_INPUT)
    for i in range(bx.shape[0]):
        want = _encode_numpy(bx[i] * ORACLE_INPUT, mask[i])
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[i].numpy(), w, rtol=1e-4, atol=1e-5)


def test_encode_yolo_targets_dtype_floor():
    bx = torch.tensor([[[0.2, 0.2, 0.5, 0.6]]])
    mask = torch.ones((1, 1), dtype=torch.bool)
    assert targets.encode_yolo_targets(bx.bfloat16(), mask, ANCHORS, SCALES,
                                       INPUT)[0].dtype == torch.float32
    assert targets.encode_yolo_targets(bx.double(), mask, ANCHORS, SCALES,
                                       INPUT)[0].dtype == torch.float64
    assert targets.head_sizes(INPUT, SCALES) == (4, 8, 16)


def test_validate_targets(rng):
    bx, mask = _random_boxes(rng, 2, 4, INPUT)
    grids = targets.encode_yolo_targets(torch.from_numpy(bx),
                                        torch.from_numpy(mask), ANCHORS,
                                        SCALES, INPUT)
    targets.validate_targets(grids, targets.head_sizes(INPUT, SCALES))
    with pytest.raises(ValueError, match="detection heads"):
        targets.validate_targets(grids[:2], (4, 8, 16))
    bad = grids[0].clone()
    bad[0, 0, 0, 0, 1] = float("nan")
    with pytest.raises(ValueError, match="NaN"):
        targets.validate_targets((bad, *grids[1:]), (4, 8, 16))


def _loss_inputs(rng, b=3):
    bx, mask = _random_boxes(rng, b, 4, INPUT, lo=4, hi=40)
    mask[:, 0] = True
    grids = [np.array(g) for g in jax_targets.encode_yolo_targets(
        jnp.asarray(bx), jnp.asarray(mask), ANCHORS, SCALES, INPUT)]
    preds = [(rng.normal(size=(b, 3, INPUT // s, INPUT // s, 4)),
              rng.normal(size=(b, 3, INPUT // s, INPUT // s, 1)) - 2.0)
             for s in SCALES]
    return [(p.astype(np.float32), o.astype(np.float32))
            for p, o in preds], grids


@pytest.mark.parametrize("iou_mode", ["elementwise", "col0"])
@pytest.mark.parametrize("fn", ["mse", "ciou"])
def test_yolo_loss_values_and_gradients_match_jax(rng, fn, iou_mode):
    preds, grids = _loss_inputs(rng)
    kw = dict(LB, bbox_loss_fn=fn, iou_mode=iou_mode)

    def jax_total(flat):
        outs = [JaxResults(bbox=flat[2 * h], obj=flat[2 * h + 1])
                for h in range(len(SCALES))]
        lb = jax_losses.yolo_loss(outs, [jnp.asarray(g) for g in grids],
                                  ANCHORS, SCALES, **kw)
        return lb.total, lb

    flat = [jnp.asarray(a) for p in preds for a in p]
    (_, want), want_grad = jax.jit(jax.value_and_grad(
        jax_total, has_aux=True))(flat)

    tflat = [torch.from_numpy(a).requires_grad_() for p in preds for a in p]
    outs = [DetectionResults(bbox=tflat[2 * h], obj=tflat[2 * h + 1])
            for h in range(len(SCALES))]
    got = losses.yolo_loss(outs, [torch.from_numpy(g) for g in grids],
                           ANCHORS, SCALES, **kw)
    got.total.backward()
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g.detach()), float(w), rtol=1e-5)
    for t, w in zip(tflat, want_grad):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-9)


def test_yolo_loss_col0_differs_from_elementwise(rng):
    """The two IoU modes give different soft labels where a (sample, head)
    has several positive cells: the col0 test above is not vacuous."""
    preds, grids = _loss_inputs(rng)
    outs = [DetectionResults(bbox=torch.from_numpy(p),
                             obj=torch.from_numpy(o)) for p, o in preds]
    tg = [torch.from_numpy(g) for g in grids]
    a = losses.yolo_loss(outs, tg, ANCHORS, SCALES, **LB, iou_mode="col0")
    b = losses.yolo_loss(outs, tg, ANCHORS, SCALES, **LB)
    assert float(a.bbox) == float(b.bbox) and float(a.obj) != float(b.obj)


def test_yolo_loss_dtype_is_prediction_dtype_floored_at_f32(rng):
    preds, grids = _loss_inputs(rng, b=1)
    tg = [torch.from_numpy(g) for g in grids]
    for dt, want in ((torch.bfloat16, torch.float32),
                     (torch.float64, torch.float64)):
        outs = [DetectionResults(bbox=torch.from_numpy(p).to(dt),
                                 obj=torch.from_numpy(o).to(dt))
                for p, o in preds]
        assert losses.yolo_loss(outs, tg, ANCHORS, SCALES,
                                **LB).total.dtype == want


def test_bce_with_logits_matches_torch(rng):
    x = torch.from_numpy(rng.normal(scale=8, size=100).astype(np.float32))
    t = torch.from_numpy(rng.uniform(size=100).astype(np.float32))
    torch.testing.assert_close(
        losses.bce_with_logits(x, t),
        torch.nn.functional.binary_cross_entropy_with_logits(
            x, t, reduction="none"), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 4, 4, 6), (3, 1, 5, 4)])
def test_batchnorm_train_update_matches_flax(rng, shape):
    """Training-mode BatchNorm: the normalized output and the running
    statistics after two updates equal flax's, whose running variance
    takes the biased batch variance (torch's own would be n / (n - 1)
    larger: 3.2 % at 32 values per channel, 6.7 % at 16)."""
    c = shape[-1]
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(size=c).astype(np.float32)
    mean0 = rng.normal(size=c).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, c).astype(np.float32)
    fbn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                        epsilon=1e-5)
    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0),
                                 "var": jnp.asarray(var0)}}
    tbn = BatchNorm2d(c).train()
    with torch.no_grad():
        tbn.weight.copy_(torch.from_numpy(scale))
        tbn.bias.copy_(torch.from_numpy(bias))
        tbn.running_mean.copy_(torch.from_numpy(mean0))
        tbn.running_var.copy_(torch.from_numpy(var0))
    for _ in range(2):
        x = (3 * rng.normal(size=shape) + 1).astype(np.float32)
        want, upd = fbn.apply(variables, jnp.asarray(x),
                              mutable=["batch_stats"])
        variables = {"params": variables["params"], **upd}
        got = tbn(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), rtol=1e-4, atol=1e-5)
    stats = variables["batch_stats"]
    np.testing.assert_allclose(tbn.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(tbn.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-5)
    # eval mode is nn.BatchNorm2d's
    tbn.eval()
    x = torch.from_numpy(rng.normal(size=(1, c, 3, 3)).astype(np.float32))
    torch.testing.assert_close(tbn(x), torch.nn.functional.batch_norm(
        x, tbn.running_mean, tbn.running_var, tbn.weight, tbn.bias,
        eps=1e-5))
