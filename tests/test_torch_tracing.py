"""The detector's spans (``uavdet_tpu_torch/tracing.py``) on the CPU at
64 px: off by default and then free of records, the span trees of a DyYOLO
and a DySOEM_SimFPN call, request ids, the profiler's ``uavdet.*`` ranges,
and the same Detections and the same exported program with tracing on."""

import io
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from uavdet_tpu_torch import tracing
from uavdet_tpu_torch.export import export_detector
from uavdet_tpu_torch.inference import make_detector, make_rtm_detector
from uavdet_tpu_torch.models import DyYOLO, DySOEM_SimFPN
from uavdet_tpu_torch.utils.seeding import init_weights, seeded_rtm_model

SIZE, BATCH = 64, 2
# the stem tokens (kernels A and B's path), then a small tail and two heads
STEM_CFG = (("DyConv", 32, 3, 1), ("DyConv", 64, 3, 2), ("B", 1),
            (128, 3, 2), ("B", 8), (256, 3, 2), (128, 1, 1),
            (256, 3, 1), ("S",), (64, 1, 1), ("U",), (64, 1, 1),
            (128, 3, 1), ("S",))
ANCHORS = [[[40, 30], [60, 46], [54, 36]], [[18, 14], [24, 18], [30, 12]],
           [[10, 8], [12, 9], [14, 6]]]
SECTIONS = {"dyyolo": ["stem", "tail", "post"],
            "dysoem": ["front", "soem", "soem", "soem", "neck", "post"],
            "rtm": ["post"]}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(kind: str):
    if kind == "dyyolo":
        return init_weights(DyYOLO(STEM_CFG, attn_temperature=30.0),
                            0).eval(), SimpleNamespace(anchors=ANCHORS[:2])
    if kind == "dysoem":
        return init_weights(DySOEM_SimFPN(stem_out_channels=8), 0).eval(), \
            SimpleNamespace(anchors=ANCHORS)
    return seeded_rtm_model(0, SIZE, device="cpu"), None


def _detector(kind: str):
    model, hp = _model(kind)
    if kind == "rtm":
        return make_rtm_detector(model, SIZE, model.det_scales)
    return make_detector(model, hp, SIZE, compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def detectors():
    return {kind: _detector(kind) for kind in SECTIONS}


def _frames(seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (BATCH, SIZE, SIZE, 3), dtype=torch.uint8,
                         generator=g)


def test_off_records_nothing(detectors):
    assert tracing.span("stem") is tracing.span("post", frames=3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        detectors["dyyolo"](_frames())
    assert not [e for e in prof.events() if e.name.startswith("uavdet.")]
    with tracing.collect() as t:
        pass
    assert t.spans == [] and t.counts == {}


@pytest.mark.parametrize("kind", sorted(SECTIONS))
def test_a_call_is_one_tree_of_spans(detectors, kind):
    with tracing.collect() as t:
        detectors[kind](_frames())
    root, *children = t.spans
    assert (root.name, root.parent, root.frames) == ("detect", -1, BATCH)
    assert [c.name for c in children] == SECTIONS[kind]
    assert {s.request for s in t.spans} == {root.request}
    for c in children:
        assert c.parent == 0
        assert root.start_ns <= c.start_ns <= c.end_ns <= root.end_ns
    for a, b in zip(children, children[1:]):
        assert a.end_ns <= b.start_ns
    assert t.counts["detect"] == {"calls": 1, "frames": BATCH}
    assert t.counts["soem" if kind == "dysoem" else "post"]["calls"] == \
        SECTIONS[kind].count("soem" if kind == "dysoem" else "post")


def test_two_calls_give_two_request_ids(detectors):
    with tracing.collect() as t:
        detectors["dyyolo"](_frames(0))
        detectors["dyyolo"](_frames(1))
    roots = [s for s in t.spans if s.parent == -1]
    assert len(roots) == 2 and roots[0].request != roots[1].request
    for s in t.spans:
        root = s if s.parent == -1 else t.spans[s.parent]
        assert s.request == root.request
    assert t.counts["detect"] == {"calls": 2, "frames": 2 * BATCH}


def test_collect_does_not_nest():
    with tracing.collect():
        with pytest.raises(RuntimeError):
            with tracing.collect():
                pass


def test_the_profiler_shows_the_spans_as_ranges(detectors):
    with tracing.collect(), profile(activities=[ProfilerActivity.CPU]) as p:
        detectors["dysoem"](_frames())
    names = [e.name for e in p.events() if e.name.startswith("uavdet.")]
    assert sorted(names) == sorted(
        "uavdet." + n for n in ["detect"] + SECTIONS["dysoem"])


@pytest.mark.parametrize("kind", ["dyyolo", "dysoem"])
def test_detections_are_the_same_with_tracing_on(detectors, kind):
    x = _frames(2)
    off = detectors[kind](x)
    with tracing.collect(), profile(activities=[ProfilerActivity.CPU]):
        on = detectors[kind](x)
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_the_exported_program_is_the_same_with_tracing_on():
    model, hp = _model("dyyolo")

    def graph(blob: bytes) -> str:
        return str(torch.export.load(io.BytesIO(blob)).graph)

    off = graph(export_detector(model, hp, SIZE, BATCH))
    with tracing.collect() as t, \
            profile(activities=[ProfilerActivity.CPU]):
        on = graph(export_detector(model, hp, SIZE, BATCH))
    assert on == off
    assert "profiler" not in on and "record_function" not in on
    # the export's one real call was traced; its trace was not
    assert t.counts["stem"]["calls"] == 1
