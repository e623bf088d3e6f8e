"""``make_detector``'s detect replayed as CUDA graphs, on the card.

Every test needs a CUDA device and skips without one (the ``card`` marker;
decided inside the ``card`` fixture). This file imports no JAX, so that it
runs on the card's host, which has none; there, without the suite's
``conftest.py`` (which sets JAX up):

    python3 -m pytest tests/test_torch_graphs.py -m card --noconftest

The eager twin of a detector is ``inference.Detector`` over the same model,
called directly: the same program, never graphed. Each test checks:

- bitwise equal answers, graphed and eager, at the first (eager), second
  (captured) and later (replayed) calls: DyYOLO at 16 x 640 and 1 x 640
  uint8, the dual detector on 2 RGB + 2 infrared frames, DySOEM_SimFPN on 2
  infrared frames at 1280;
- 8 distinct batches in turn, every answer kept: each still equals its
  twin (no answer aliases the graphs' static output);
- a weight changed in place, and a parameter replaced, show in the next
  call;
- ``kernels.launch_counts()`` per call as eager;
- under ``tracing.collect()`` and the profiler, the spans' device time sums
  to the busy time, with nothing outside every span;
- deleting the detector gives its memory back;
- a replay reads the cached tables its capture read (the dual detector's
  resize matrices, the decode's head tables) after their caches dropped
  them and their memory was written over;
- captured and replayed while a data pipeline decodes ahead on its side
  stream (evaluate's loop), every answer equals its twin;
- a capture that fails leaves the call eager, and the next call captures;
- ``make_rtm_detector`` (RTMUAVDet at 8 x 640) through the same graphs:
  eager, then captured, then replayed, each bitwise the eager call; a
  second signature captures a set of its own; a moved weight drops the
  graphs; its spans hold the replayed device time.
"""

import gc
import os

import pytest
import torch

from uavdet_tpu_torch import kernels, tracing
from uavdet_tpu_torch.inference import (Detector, make_detector,
                                        make_rtm_detector)
from uavdet_tpu_torch.models import DYSOEM, DYYOLO
from uavdet_tpu_torch.models.rtm_uav_det import rtm_det_scales
from uavdet_tpu_torch.utils.seeding import seeded_model, seeded_rtm_model

pytestmark = pytest.mark.card
SIZE, SOEM_SIZE = 640, 1280


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; this host has none")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def dyyolo(card):
    return seeded_model("DyYOLO", DYYOLO, 0, device=card)


@pytest.fixture(scope="module")
def dysoem(card):
    return seeded_model("DySOEM_SimFPN", DYSOEM, 0, device=card)


@pytest.fixture(scope="module")
def rtm(card):
    return seeded_rtm_model(0, SIZE, device=card)


def _frames(card, seed, shape):
    g = torch.Generator(device=card).manual_seed(seed)
    return torch.randint(0, 256, shape, dtype=torch.uint8, device=card,
                         generator=g)


def _twin(model, hp, size, dual=False):
    det = Detector(model, hp, size, dual=dual)

    @torch.inference_mode()
    def run(*frames):
        return det(*frames)
    return run


def _equal(got, want) -> bool:
    return all(torch.equal(a, b) for a, b in zip(got, want))


def _counts(fn, *frames) -> dict:
    with tracing.collect() as t:
        fn(*frames)
    return {k: v["calls"] for k, v in t.counts.items()
            if k.startswith("graph_")}


@pytest.mark.parametrize("case", ["dyyolo_b16", "dyyolo_b1", "dual_2_2",
                                  "dysoem_b2"])
def test_replay_is_bitwise_the_eager_detector(card, dyyolo, dysoem, case):
    if case == "dysoem_b2":
        model, hp, size = dysoem, DYSOEM, SOEM_SIZE
        frames = (_frames(card, 1, (2, SOEM_SIZE, SOEM_SIZE, 3)),)
    elif case == "dual_2_2":
        model, hp, size = dyyolo, DYYOLO, SIZE
        frames = (_frames(card, 2, (2, 1080, 1920, 3)),
                  _frames(card, 3, (2, 512, 640, 3)))
    else:
        model, hp, size = dyyolo, DYYOLO, SIZE
        b = 16 if case == "dyyolo_b16" else 1
        frames = (_frames(card, 4, (b, SIZE, SIZE, 3)),)
    dual = len(frames) == 2
    detect = make_detector(model, hp, size, dual=dual)
    want = _twin(model, hp, size, dual)(*frames)
    assert _counts(detect, *frames) == {"graph_eager": 1}
    assert _counts(detect, *frames) == {"graph_capture": 1}
    assert _counts(detect, *frames) == {"graph_replay": 1}
    for _ in range(2):
        got = detect(*frames)
        assert _equal(got, want)
        assert got.valid.any()


def test_kept_answers_stay_their_own(card, dyyolo):
    """8 distinct batches called in turn, twice over, every answer kept:
    each equals its eager twin at the end."""
    detect = make_detector(dyyolo, DYYOLO, SIZE)
    twin = _twin(dyyolo, DYYOLO, SIZE)
    batches = [_frames(card, 10 + i, (4, SIZE, SIZE, 3)) for i in range(8)]
    kept = [detect(x) for _ in range(2) for x in batches]
    with tracing.collect() as t:
        kept += [detect(x) for x in batches]
    assert t.counts["graph_replay"]["calls"] == 8
    for i, got in enumerate(kept):
        assert _equal(got, twin(batches[i % 8]))


def test_a_weight_change_shows_in_the_next_call(card):
    model = seeded_model("DyYOLO", DYYOLO, 1, device=card)
    detect = make_detector(model, DYYOLO, SIZE)
    twin = _twin(model, DYYOLO, SIZE)
    x = _frames(card, 20, (2, SIZE, SIZE, 3))
    for _ in range(3):
        before = detect(x)
    bn = next(m for m in model.layers[-1].modules()   # the last head's
              if isinstance(m, torch.nn.BatchNorm2d))
    with torch.no_grad():
        bn.bias.add_(0.5)   # in place: the graphs read it there
    assert _counts(detect, x) == {"graph_replay": 1}
    changed = detect(x)
    assert _equal(changed, twin(x)) and not _equal(changed, before)
    bn.bias = torch.nn.Parameter(bn.bias.detach() - 1.0)   # replaced
    assert _counts(detect, x) == {"graph_eager": 1}
    assert _equal(detect(x), twin(x))   # captured again
    assert _counts(detect, x) == {"graph_replay": 1}
    assert _equal(detect(x), twin(x))


def test_launch_counts_per_call_are_eager_s(card, dyyolo, dysoem):
    for model, hp, size, b in ((dyyolo, DYYOLO, SIZE, 2),
                               (dysoem, DYSOEM, SOEM_SIZE, 1)):
        x = _frames(card, 30, (b, size, size, 3))
        twin = _twin(model, hp, size)
        kernels.reset_launch_counts()
        for _ in range(4):
            twin(x)
        eager = kernels.launch_counts()
        assert any(eager.values())
        detect = make_detector(model, hp, size)
        kernels.reset_launch_counts()
        for _ in range(4):   # eager, capture, replay, replay
            detect(x)
        assert kernels.launch_counts() == eager


@pytest.mark.parametrize("name", ["dyyolo", "dysoem", "rtm"])
def test_spans_hold_all_the_replayed_device_time(card, dyyolo, dysoem, rtm,
                                                 name):
    from torch.profiler import ProfilerActivity, profile

    from perfbench import spans as bench_spans
    from perfbench import trace

    if name == "rtm":
        size = SIZE
        detect = make_rtm_detector(rtm, size, rtm_det_scales(size))
    else:
        model, hp, size = ((dyyolo, DYYOLO, SIZE) if name == "dyyolo"
                           else (dysoem, DYSOEM, SOEM_SIZE))
        detect = make_detector(model, hp, size)
    x = _frames(card, 40, (2, size, size, 3))
    for _ in range(3):
        detect(x)
    torch.cuda.synchronize()
    with tracing.collect() as t, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(3):
            detect(x)
        torch.cuda.synchronize()
    assert t.counts["graph_replay"]["calls"] == 3
    host, device = bench_spans.profile_events(p)
    device = [d for d in device if not d.name.startswith("uavdet.")]
    by_span = bench_spans.attribute(host, device)
    assert None not in by_span
    sections = {"dyyolo": {"stem", "tail", "post"},
                "dysoem": {"front", "soem", "neck", "post"},
                "rtm": {"stem", "csp", "fuse", "norm", "mdy", "mlp", "head",
                        "post"}}[name]
    assert sections <= set(by_span) <= sections | {"detect"}
    busy = trace.union_us(device)
    total = sum(trace.union_us(v) for v in by_span.values())
    assert busy > 0 and abs(total - busy) <= 1e-3 * busy


def test_deleting_the_detector_frees_its_graphs(card, dyyolo):
    x = _frames(card, 50, (2, SIZE, SIZE, 3))

    def run():
        detect = make_detector(dyyolo, DYYOLO, SIZE)
        for _ in range(3):
            detect(x)
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated(card)

    run()   # the process's one-time state: the capture stream's workspaces
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(card)
    assert run() > before
    gc.collect()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_allocated(card) == before


def test_replay_keeps_the_tables_its_capture_read(card, dyyolo):
    """The tables a capture read from the bounded caches, dropped by them
    (40 other resize shapes, then cleared) and their blocks handed out
    again filled with NaN and -1: the replay still reads its own."""
    from uavdet_tpu_torch.inference import _head_tables
    from uavdet_tpu_torch.ops.resize import _weights_on
    frames = (_frames(card, 60, (2, 1080, 1920, 3)),
              _frames(card, 61, (2, 512, 640, 3)))
    want = _twin(dyyolo, DYYOLO, SIZE, dual=True)(*frames)
    detect = make_detector(dyyolo, DYYOLO, SIZE, dual=True)
    for _ in range(2):   # eager, captured
        detect(*frames)
    for n in range(100, 140):
        _weights_on(card, torch.float32, n, SIZE)
    _weights_on.cache_clear()
    _head_tables.cache_clear()
    gc.collect()
    torch.cuda.synchronize()
    junk = [torch.full((n, SIZE), float("nan"), device=card)
            for n in (1080, 1920, 512) for _ in range(4)]
    junk += [torch.full((k,), -1, dtype=torch.int64, device=card)
             for k in range(1, 64) for _ in range(4)]
    assert _counts(detect, *frames) == {"graph_replay": 1}
    assert _equal(detect(*frames), want)
    del junk


def test_a_capture_beside_a_prefetching_pipeline(card, dyyolo, tmp_path):
    """evaluate's loop: the detector is captured and replayed while the
    data pipeline's producer thread decodes the next batches with nvJPEG
    on its side stream. No capture fails, and every answer equals its
    eager twin."""
    from uavdet_tpu_torch.data import DataPipeline, make_synthetic_dataset
    from uavdet_tpu_torch.data.antiuav import build_index
    root = make_synthetic_dataset(str(tmp_path), splits=("val",), n_seq=4,
                                  n_frames=12, img_size=SIZE, device=card)
    pipe = DataPipeline(build_index(os.path.join(root, "val")), SIZE, 2,
                        train=False, workers=4, prefetch=4, device=card)
    detect = make_detector(dyyolo, DYYOLO, SIZE)
    kept = []
    with tracing.collect() as t:
        for batch in pipe:
            kept.append((batch.image.clone(), detect(batch.image)))
    assert len(kept) > 8
    assert {k: v["calls"] for k, v in t.counts.items()
            if k.startswith("graph_")} == {
        "graph_eager": 1, "graph_capture": 1, "graph_replay": len(kept) - 2}
    twin = _twin(dyyolo, DYYOLO, SIZE)
    for x, got in kept:
        assert _equal(got, twin(x))


def test_a_failed_capture_is_tried_again(card, dyyolo, monkeypatch):
    """A capture spoiled by a call CUDA does not allow in one (a device
    synchronize) warns and runs eagerly; the next call captures."""
    from uavdet_tpu_torch import inference
    real, tries = inference._GraphSet, []

    def flaky(fn, frames):
        tries.append(fn)
        if len(tries) > 1:
            return real(fn, frames)

        def spoiled(*f):
            if torch.cuda.is_current_stream_capturing():
                torch.cuda.synchronize()
            return fn(*f)
        return real(spoiled, frames)

    monkeypatch.setattr(inference, "_GraphSet", flaky)
    detect = make_detector(dyyolo, DYYOLO, SIZE)
    x = _frames(card, 70, (2, SIZE, SIZE, 3))
    want = _twin(dyyolo, DYYOLO, SIZE)(x)
    assert _counts(detect, x) == {"graph_eager": 1}
    with pytest.warns(UserWarning, match="capture as CUDA graphs failed"):
        assert _counts(detect, x) == {"graph_eager": 1}
    assert _counts(detect, x) == {"graph_capture": 1}
    assert _counts(detect, x) == {"graph_replay": 1}
    assert len(tries) == 2 and _equal(detect(x), want)


def test_rtm_replay_is_bitwise_its_eager_call(card, rtm):
    """``make_rtm_detector`` on the same ``_Graphs``: a signature's first
    call eager, its second captured, then replayed, each answer bitwise the
    eager one; a second signature captures a set of its own while the first
    still replays; a parameter replaced (same values, another storage)
    drops the graphs, and the call after captures again."""
    detect = make_rtm_detector(rtm, SIZE, rtm_det_scales(SIZE))
    x = _frames(card, 80, (8, SIZE, SIZE, 3))
    y = _frames(card, 81, (2, SIZE, SIZE, 3))

    def call(frames):
        with tracing.collect() as t:
            out = detect(frames)
        return out, {k: v["calls"] for k, v in t.counts.items()
                     if k.startswith("graph_")}

    want, counts = call(x)
    assert counts == {"graph_eager": 1} and want.valid.any()
    for mode in ("graph_capture", "graph_replay", "graph_replay"):
        got, counts = call(x)
        assert counts == {mode: 1} and _equal(got, want)
    want_y, counts = call(y)
    assert counts == {"graph_eager": 1}
    for mode in ("graph_capture", "graph_replay"):
        got, counts = call(y)
        assert counts == {mode: 1} and _equal(got, want_y)
    got, counts = call(x)
    assert counts == {"graph_replay": 1} and _equal(got, want)
    bn = rtm.stem.bn
    bn.bias = torch.nn.Parameter(bn.bias.detach().clone())
    for mode in ("graph_eager", "graph_capture", "graph_replay"):
        got, counts = call(x)
        assert counts == {mode: 1} and _equal(got, want)
