"""The port's NMS (uavdet_tpu_torch/ops/nms.py) against the JAX package.

On the CPU ``nms_alive`` runs the plain PyTorch version of the CUDA kernel,
the one the card compares its kernel with. Every comparison here is exact:
both sides evaluate the same f32 operations in the same order on the same
inputs, so any difference is a semantic one.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from uavdet_tpu.ops.boxes import box_iou_pairwise as jax_iou
from uavdet_tpu.ops.nms import batched_nms as jax_batched_nms
from uavdet_tpu.ops.nms import nms as jax_nms
from uavdet_tpu.ops.pallas_nms import pallas_nms_alive
from uavdet_tpu_torch import kernels
from uavdet_tpu_torch.ops.boxes import box_iou_pairwise
from uavdet_tpu_torch.ops.nms import (MAX_BOXES, MAX_BOXES_LARGE,
                                      NMS_EDGE_CASES,
                                      _nms_alive_cuda, batched_nms, nms,
                                      nms_alive, nms_alive_plain,
                                      nms_edge_case)


def _case(rng, n, b=2):
    """Crowded xyxy boxes with duplicates, equal scores, zero-area boxes and
    -inf padding, as the detector hands them to NMS."""
    xy = rng.uniform(0, 200, size=(b, n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 60, size=(b, n, 2))],
                           axis=-1).astype(np.float32)
    scores = rng.uniform(size=(b, n)).astype(np.float32)
    d = n // 8
    boxes[:, d:2 * d] = boxes[:, :d]                  # exact duplicates
    scores[:, d:2 * d] = scores[:, :d]                # ... with equal scores
    scores[:, 2 * d:3 * d] = 0.5                      # a run of ties
    boxes[:, 3 * d:3 * d + d // 2, 2:] = boxes[:, 3 * d:3 * d + d // 2, :2]
    pad = n // 10
    boxes[:, n - pad:] = 0.0                          # padding
    scores[:, n - pad:] = -np.inf
    return boxes, scores


@pytest.mark.parametrize("n", [512, 100])
def test_batched_nms_matches_jax(rng, n):
    """n=512 runs the blocked recurrence, n=100 the rank-by-rank one."""
    boxes, scores = _case(rng, n)
    keep, alive, order = batched_nms(torch.from_numpy(boxes),
                                     torch.from_numpy(scores), 0.5, 300)
    for i in range(boxes.shape[0]):
        j_keep, j_alive, j_order = jax_nms(jnp.asarray(boxes[i]),
                                           jnp.asarray(scores[i]), 0.5, 300)
        np.testing.assert_array_equal(order[i].numpy(), np.asarray(j_order))
        np.testing.assert_array_equal(alive[i].numpy(), np.asarray(j_alive))
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(j_keep))
        # the single-image wrapper is the same computation
        s_keep, s_alive, s_order = nms(torch.from_numpy(boxes[i]),
                                       torch.from_numpy(scores[i]), 0.5, 300)
        assert torch.equal(s_keep, keep[i]) and torch.equal(s_alive, alive[i])
    # the case must exercise suppression and padding both
    assert 0 < int(alive.sum()) < alive.numel() - 2 * (n // 10)


@pytest.mark.parametrize("n", [512, 128])
def test_nms_alive_matches_pallas_kernel(rng, n):
    """The survivor mask against the TPU kernel itself (interpret mode), on
    score-sorted boxes."""
    boxes, scores = _case(rng, n)
    order = np.argsort(-scores, axis=1, kind="stable")
    boxes_s = np.take_along_axis(boxes, order[..., None], axis=1)
    want = np.asarray(pallas_nms_alive(jnp.asarray(boxes_s), 0.5,
                                       interpret=True))
    got = nms_alive(torch.from_numpy(boxes_s), 0.5)
    np.testing.assert_array_equal(got.numpy(), want)


def test_iou_is_bitwise_the_reference(rng):
    boxes, _ = _case(rng, 64, b=1)
    got = box_iou_pairwise(torch.from_numpy(boxes[0]),
                           torch.from_numpy(boxes[0]))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_iou(jnp.asarray(boxes[0]),
                                        jnp.asarray(boxes[0]))))


def test_threshold_is_strict():
    # IoU exactly 0.6 at threshold 0.6 -> not suppressed; at 0.5 it is
    boxes = torch.tensor([[[0, 0, 10, 20], [0, 5, 10, 25]]
                          + [[0, 0, 0, 0]] * 30], dtype=torch.float32)
    assert nms_alive(boxes, 0.6)[0, :2].tolist() == [True, True]
    assert nms_alive(boxes, 0.5)[0, :2].tolist() == [True, False]
    assert nms_alive(boxes, 0.5)[0, 2:].all()   # zero-area padding survives


def test_cpu_nms_launches_no_kernel(rng):
    boxes, scores = _case(rng, 64)
    batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5, 10)
    assert kernels.launch_counts()["nms"] == 0


def _ids(case):
    return "-".join(map(str, case))


def test_nms_edge_cases_straddle_the_kernel_layout():
    """The tuple the smoke test also reads: sizes on both sides of a 64-rank
    mask word, not multiples of the 8 blocks of a cluster, the detector's
    shape, the largest the shared-memory mask takes and one past it, and
    mask rows of 32 and of 64 words (the walk's lanes hold one or two)."""
    sizes = [n for _, _, n in NMS_EDGE_CASES]
    assert 1 in sizes and MAX_BOXES in sizes and 512 in sizes
    assert MAX_BOXES + 1 in sizes and 2048 in sizes and 4096 in sizes
    assert any(n % 64 == 63 for n in sizes) and any(n % 64 == 1 for n in sizes)
    assert any(n % 8 and n % 64 for n in sizes)
    assert {"crowded", "identical", "disjoint"} == {k for k, _, _
                                                    in NMS_EDGE_CASES}
    assert any(b > 1 for _, b, _ in NMS_EDGE_CASES)
    with pytest.raises(ValueError, match="unknown kind"):
        nms_edge_case("sparse", 1, 8, np.random.default_rng(0))


def _small(cases):
    return [c for c in cases if c[2] <= MAX_BOXES]


def _large(cases):
    return [c for c in cases if c[2] > MAX_BOXES]


@pytest.mark.parametrize("case", _small(NMS_EDGE_CASES), ids=_ids)
def test_nms_alive_plain_edge_cases_match_jax(rng, case):
    """The plain version at every edge case against the JAX package's NMS,
    image by image: order, survivor mask and kept indices, bitwise."""
    kind, b, n = case
    boxes, scores = nms_edge_case(kind, b, n, rng)
    keep, alive, order = batched_nms(torch.from_numpy(boxes),
                                     torch.from_numpy(scores), 0.5,
                                     min(n, 300), alive_fn=nms_alive_plain)
    for i in range(b):
        j_keep, j_alive, j_order = jax_nms(jnp.asarray(boxes[i]),
                                           jnp.asarray(scores[i]), 0.5,
                                           min(n, 300))
        np.testing.assert_array_equal(order[i].numpy(), np.asarray(j_order))
        np.testing.assert_array_equal(alive[i].numpy(), np.asarray(j_alive))
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(j_keep))
    survivors = alive.sum(dim=1)
    if kind == "identical":
        assert survivors.tolist() == [1] * b
    elif kind == "disjoint":
        assert survivors.tolist() == [n] * b
    elif n >= 63:   # suppression and padding both happen
        assert (survivors > 0).all() and (survivors < n - n // 10).all()


@pytest.mark.parametrize("case", [c for c in _small(NMS_EDGE_CASES)
                                  if c[2] % 128 == 0], ids=_ids)
def test_nms_alive_plain_edge_cases_match_pallas_kernel(rng, case):
    """Where the TPU kernel takes N (whole lanes of 128): the survivor mask
    against ``pallas_nms_alive`` in interpret mode, bitwise."""
    kind, b, n = case
    boxes, scores = nms_edge_case(kind, b, n, rng)
    order = np.argsort(-scores, axis=1, kind="stable")
    boxes_s = np.take_along_axis(boxes, order[..., None], axis=1)
    want = np.asarray(pallas_nms_alive(jnp.asarray(boxes_s), 0.5,
                                       interpret=True))
    got = nms_alive_plain(torch.from_numpy(boxes_s), 0.5)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", _large(NMS_EDGE_CASES), ids=_ids)
def test_nms_alive_plain_large_cases_match_jax_batched_nms(rng, case):
    """Past ``MAX_BOXES`` (the kernel's path with the mask in device
    memory): the plain version against the XLA NMS the JAX detector runs,
    ``uavdet_tpu.ops.nms.batched_nms``: order, survivor mask and kept
    indices, bitwise. (The Pallas kernel in interpret mode is too slow at
    these sizes.)"""
    kind, b, n = case
    boxes, scores = nms_edge_case(kind, b, n, rng)
    keep, alive, order = batched_nms(torch.from_numpy(boxes),
                                     torch.from_numpy(scores), 0.5, 300,
                                     alive_fn=nms_alive_plain)
    j_keep, j_alive, j_order = jax_batched_nms(jnp.asarray(boxes),
                                               jnp.asarray(scores), 0.5, 300)
    np.testing.assert_array_equal(order.numpy(), np.asarray(j_order))
    np.testing.assert_array_equal(alive.numpy(), np.asarray(j_alive))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(j_keep))
    survivors = alive.sum(dim=1)
    assert (survivors > 0).all() and (survivors < n - n // 10).all()


def test_nms_kernel_wrapper_rules(rng):
    """The kernel's wrapper raises before any launch on what the kernel does
    not take, whatever the device: another dtype or last dimension, no box
    or more than ``MAX_BOXES_LARGE``, no image, boxes off a 16-byte
    boundary; the stamped measuring kernel past ``MAX_BOXES``."""
    boxes = torch.zeros((2, 64, 4))
    with pytest.raises(ValueError, match="float32"):
        _nms_alive_cuda(boxes.double(), 0.5)
    with pytest.raises(ValueError, match="float32"):
        _nms_alive_cuda(boxes.to(torch.bfloat16), 0.5)
    with pytest.raises(ValueError, match=r"\(B, N, 4\)"):
        _nms_alive_cuda(torch.zeros((2, 64, 5)), 0.5)
    with pytest.raises(ValueError, match=f"1 to {MAX_BOXES_LARGE} boxes"):
        _nms_alive_cuda(torch.zeros((2, 0, 4)), 0.5)
    with pytest.raises(ValueError, match=f"1 to {MAX_BOXES_LARGE} boxes"):
        _nms_alive_cuda(torch.zeros((1, MAX_BOXES_LARGE + 1, 4)), 0.5)
    with pytest.raises(ValueError, match="stamped kernel"):
        _nms_alive_cuda(torch.zeros((1, MAX_BOXES + 1, 4)), 0.5,
                        torch.zeros((1, 3), dtype=torch.int64))
    with pytest.raises(ValueError, match="at least one image"):
        _nms_alive_cuda(torch.zeros((0, 64, 4)), 0.5)
    off = torch.zeros(2 * 64 * 4 + 1)[1:].view(2, 64, 4)
    assert off.is_contiguous() and off.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        _nms_alive_cuda(off, 0.5)
    with pytest.raises(ValueError, match="no NMS for device"):
        nms_alive(boxes.to("meta"), 0.5)
    assert kernels.launch_counts()["nms"] == 0


def test_cpu_nms_handles_what_the_kernel_refuses():
    """On the CPU the plain version runs: it takes N = 0 and more boxes than
    a cluster's shared memory holds, and launches no kernel."""
    assert nms_alive(torch.zeros((2, 0, 4)), 0.5).shape == (2, 0)
    n = MAX_BOXES + 32
    xy = torch.arange(n, dtype=torch.float32)[None, :, None] * 50.0
    alive = nms_alive(torch.cat([xy, xy, xy + 30, xy + 30], dim=-1), 0.5)
    assert alive.shape == (1, n) and bool(alive.all())
    assert kernels.launch_counts()["nms"] == 0
