"""The port's other decodes (``inference.decode_all_heads``,
``decode_topk_heads``, ``_topk_wide``) against the JAX package's, on the
CPU, mirroring tests/test_inference.py.

Both sides decode the same f32 (or bf16) logits. The decoded boxes agree to
f32 rounding (the two frameworks' sigmoids and products round apart by an
ulp or so): boxes rtol 1e-5 with atol 1e-4 px, scores rtol 1e-6; indices and
kept logits are exact. ``_topk_wide`` is held to one stable descending sort:
values and indices, ties included.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from uavdet_tpu.inference import _topk_wide as jax_topk_wide
from uavdet_tpu.inference import decode_all_heads as jax_decode_all_heads
from uavdet_tpu.inference import decode_topk_heads as jax_decode_topk_heads
from uavdet_tpu.utils.datatypes import DetectionResults as JaxResults
from uavdet_tpu_torch.inference import (_TOPK_CHUNK, _topk_wide,
                                        decode_all_heads, decode_topk_global,
                                        decode_topk_heads)
from uavdet_tpu_torch.utils.datatypes import DetectionResults

ANCHORS = np.asarray([[[40, 30], [60, 46], [54, 36]],
                      [[18, 14], [24, 18], [30, 12]],
                      [[6, 5], [10, 6], [13, 8]]], np.float32)
SIZES, SCALES = (4, 8, 16), (16, 8, 4)


def _heads(rng, batch=2, dtype=np.float32):
    """(the port's heads, JAX's heads) from the same random logits."""
    port, jax_ = [], []
    for s in SIZES:
        bbox = rng.normal(size=(batch, 3, s, s, 4)).astype(np.float32)
        obj = rng.normal(size=(batch, 3, s, s, 1)).astype(np.float32)
        if dtype == "bf16":
            bbox = np.asarray(jnp.asarray(bbox, jnp.bfloat16), np.float32)
            obj = np.asarray(jnp.asarray(obj, jnp.bfloat16), np.float32)
            port.append(DetectionResults(
                bbox=torch.from_numpy(bbox).to(torch.bfloat16),
                obj=torch.from_numpy(obj).to(torch.bfloat16)))
            jax_.append(JaxResults(bbox=jnp.asarray(bbox, jnp.bfloat16),
                                   obj=jnp.asarray(obj, jnp.bfloat16)))
        else:
            port.append(DetectionResults(bbox=torch.from_numpy(bbox),
                                         obj=torch.from_numpy(obj)))
            jax_.append(JaxResults(bbox=jnp.asarray(bbox),
                                   obj=jnp.asarray(obj)))
    return port, jax_


@pytest.mark.parametrize("mode", ["mse", "ciou"])
def test_decode_all_heads_matches_jax(rng, mode):
    port, jax_ = _heads(rng)
    gb, gs = decode_all_heads(port, ANCHORS, SCALES, mode)
    wb, ws = jax_decode_all_heads(jax_, ANCHORS, SCALES, mode)
    assert gb.shape == (2, 3 * sum(s * s for s in SIZES), 4)
    assert gb.dtype == gs.dtype == torch.float32
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6)


def test_decode_all_heads_zero_logits():
    """Zero logits: centre half a cell in, w and h the anchor's, score 0.5
    (tests/test_inference.py:123)."""
    outs = [DetectionResults(bbox=torch.zeros((1, 3, s, s, 4)),
                             obj=torch.zeros((1, 3, s, s, 1))) for s in SIZES]
    boxes, scores = decode_all_heads(outs, ANCHORS, SCALES, "mse")
    b0 = boxes[0, 0].numpy()
    assert (b0[0] + b0[2]) / 2 == pytest.approx(8.0, abs=1e-4)
    assert (b0[1] + b0[3]) / 2 == pytest.approx(8.0, abs=1e-4)
    assert b0[2] - b0[0] == pytest.approx(40.0, rel=1e-5)
    assert b0[3] - b0[1] == pytest.approx(30.0, rel=1e-5)
    assert float(scores[0, 0]) == 0.5


@pytest.mark.parametrize("k", [24, 1000])
def test_decode_topk_heads_matches_jax(rng, k):
    """f32 logits; k = 1000 keeps every candidate of the two small heads."""
    port, jax_ = _heads(rng)
    gb, gs = decode_topk_heads(port, ANCHORS, SCALES, k)
    wb, ws = jax_decode_topk_heads(jax_, ANCHORS, SCALES, k)
    assert gb.shape == (2, sum(min(k, 3 * s * s) for s in SIZES), 4)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("mode", ["mse", "ciou"])
def test_decode_topk_heads_is_the_full_decodes_top_k(rng, mode):
    """Per head, the top-k of ``decode_all_heads`` by score (both modes
    decode to the same pixels): tests/test_inference.py:181."""
    port, _ = _heads(rng)
    k = 24
    fb, fs = decode_all_heads(port, ANCHORS, SCALES, mode)
    want_b, want_s, off = [], [], 0
    for s in SIZES:
        n = 3 * s * s
        ts, ti = torch.sort(fs[:, off:off + n], dim=1, descending=True,
                            stable=True)
        want_s.append(ts[:, :k])
        want_b.append(torch.gather(fb[:, off:off + n], 1,
                                   ti[:, :k, None].expand(-1, k, 4)))
        off += n
    gb, gs = decode_topk_heads(port, ANCHORS, SCALES, k)
    np.testing.assert_allclose(gs.numpy(), torch.cat(want_s, 1).numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(gb.numpy(), torch.cat(want_b, 1).numpy(),
                               rtol=1e-5, atol=1e-4)


def test_decode_topk_heads_logits_bitwise_in_bf16(rng):
    """``return_logits``: the kept logits in their native bf16, bitwise the
    JAX package's; their global stable sort gives ``decode_topk_global``'s
    candidates (tests/test_inference.py:300)."""
    port, jax_ = _heads(rng, dtype="bf16")
    k = 32
    gb, gs, gl = decode_topk_heads(port, ANCHORS, SCALES, k,
                                   return_logits=True)
    wb, ws, wl = jax_decode_topk_heads(jax_, ANCHORS, SCALES, k,
                                       return_logits=True)
    assert gl.dtype == torch.bfloat16
    np.testing.assert_array_equal(gl.float().numpy(),
                                  np.asarray(wl, np.float32))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=1e-5,
                               atol=1e-4)
    order = torch.sort(gl, dim=1, descending=True, stable=True)[1][:, :k]
    tb, ts = decode_topk_global(port, ANCHORS, SCALES, k)
    torch.testing.assert_close(torch.gather(gs, 1, order), ts, rtol=0,
                               atol=0)
    torch.testing.assert_close(
        torch.gather(gb, 1, order[..., None].expand(-1, -1, 4)), tb,
        rtol=0, atol=0)


def _stable_top(x, k):
    v, i = torch.sort(x, dim=1, descending=True, stable=True)
    return v[:, :k], i[:, :k]


@pytest.mark.parametrize("n,k,data", [
    (4 * _TOPK_CHUNK + 1234, 64, "quarters"),   # chunked, -inf padding
    (4 * _TOPK_CHUNK, 512, "integers"),         # chunked, few values
    (7 * _TOPK_CHUNK, 8192, "normal"),          # past the JAX guard
    (3 * _TOPK_CHUNK, 100, "integers"),         # one sort
])
def test_topk_wide_is_one_stable_sort(rng, n, k, data):
    """Values and indices equal the first k of one stable descending sort,
    ties included, and the JAX function's (``lax.top_k`` is stable)."""
    if data == "quarters":      # bf16 values dense with ties
        x = np.round(rng.normal(size=(3, n)) * 4) / 4
    elif data == "integers":    # each value thousands of times
        x = rng.integers(-8, 8, size=(2, n)).astype(np.float32)
        x[:, rng.choice(n, 50, replace=False)] = -np.inf
    else:
        x = rng.normal(size=(2, n))
    xt = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    gv, gi = _topk_wide(xt, k)
    wv, wi = _stable_top(xt, k)
    assert torch.equal(gv, wv) and torch.equal(gi, wi)
    jv, ji = jax_topk_wide(jnp.asarray(x, jnp.bfloat16), k)
    np.testing.assert_array_equal(gv.float().numpy(),
                                  np.asarray(jv, np.float32))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ji))
    rv, ri = jax.lax.top_k(jnp.asarray(x, jnp.bfloat16), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
