"""The detector's spans (``uavdet_tpu_torch/tracing.py``) on the CPU at
64 px: off by default and then free of records, the span trees of a
DyYOLO, a DySOEM_SimFPN and an RTMUAVDet call, request ids, the profiler's
``uavdet.*`` ranges, and the same Detections and the same exported program
with tracing on.
Then what the CUDA graphs of ``make_detector`` rest on that the CPU can
show: a CPU call stays eager and counts so, the rule that decides where a
call may be graphed, the weights' pointers, the cached tables a capture
keeps, the span boundaries a capture cuts at, and the counters. The graphs themselves are tested on the card
(``tests/test_torch_graphs.py``)."""

import io
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from uavdet_tpu_torch import tracing
from uavdet_tpu_torch.export import export_detector
from uavdet_tpu_torch.inference import (Detector, _Weights, graph_safe,
                                        make_detector, make_rtm_detector)
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
            "rtm": ["stem", "csp", "csp", "fuse", "norm", "mdy", "norm",
                    "mlp", "fuse", "norm", "mdy", "norm", "mlp", "head",
                    "post"]}


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


@pytest.mark.parametrize("kind", ["dyyolo", "dysoem", "rtm"])
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


def test_a_cpu_detect_runs_eagerly_and_counts_it(detectors):
    """On the CPU every call of make_detector's detect is the eager
    ``Detector`` call, counted ``graph_eager``, however often a signature
    comes back."""
    model, hp = _model("dyyolo")
    twin = Detector(model, hp, SIZE, compute_dtype=torch.float32)
    x = _frames(3)
    with torch.inference_mode():
        want = twin(x)
    with tracing.collect() as t:
        got = [detectors["dyyolo"](x) for _ in range(3)]
    for d in got:
        for a, b in zip(d, want):
            assert torch.equal(a, b)
    assert t.counts["graph_eager"] == {"calls": 3, "frames": 3 * BATCH}
    assert "graph_replay" not in t.counts
    assert "graph_capture" not in t.counts


@pytest.mark.parametrize("case", ["cpu", "training", "autocast", "mesh",
                                  "export"])
def test_graph_safe_falls_back_to_eager(monkeypatch, case):
    """Each condition alone keeps a call eager; the same call on a CUDA
    device with none of them may be graphed."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    model, _ = _model("dyyolo")
    cuda = torch.device("cuda")
    assert graph_safe(cuda, model)
    if case == "cpu":
        assert not graph_safe(torch.device("cpu"), model)
    elif case == "training":
        model.train()
        assert not graph_safe(cuda, model)
        model.eval()
    elif case == "autocast":
        torch.set_autocast_enabled("cuda", True)
        try:
            assert not graph_safe(cuda, model)
        finally:
            torch.set_autocast_enabled("cuda", False)
    elif case == "mesh":
        assert not graph_safe(cuda, model, mesh=object())
    else:
        seen = []

        class Probe(torch.nn.Module):
            def forward(self, x):
                seen.append(graph_safe(cuda, model))
                return x + 1

        torch.export.export(Probe(), (torch.ones(2),), strict=False)
        assert seen == [False]
    assert graph_safe(cuda, model)


def test_the_weights_say_when_a_graph_would_read_stale_ones():
    """A change in place keeps every parameter and buffer where the graphs
    read it; a replaced parameter or module and a moved storage each show
    once, at the next call."""
    model, _ = _model("dyyolo")
    reads = _Weights(model)
    assert sorted(reads.ptrs) == sorted(t.data_ptr() for t in [
        *model.parameters(), *model.buffers()])
    conv = model.layers[3].conv
    with torch.no_grad():
        conv.weight.mul_(2)
    assert not reads.moved()
    conv.weight = torch.nn.Parameter(conv.weight.detach().clone())
    assert reads.moved() and not reads.moved()
    assert conv.weight.data_ptr() in reads.ptrs
    conv.weight.data = conv.weight.data.clone()
    assert reads.moved() and not reads.moved()
    model.layers[3].conv = torch.nn.Conv2d(conv.in_channels,
                                           conv.out_channels, 1)
    assert reads.moved() and not reads.moved()
    torch.nn.Linear(2, 2)   # registrations elsewhere: walked again, same
    assert not reads.moved()


def test_span_off_is_the_shared_noop():
    """With tracing off, and again after a cut ended, span() is the one
    shared no-op; a cut on another thread leaves this thread's spans
    off."""
    assert tracing.span("stem") is tracing._OFF
    with tracing.cut_at_spans(lambda name, frames: None):
        import threading
        other = []
        th = threading.Thread(target=lambda: other.append(
            tracing.span("tail")))
        th.start()
        th.join(timeout=10)
        assert not th.is_alive() and other == [tracing._OFF]
        assert tracing.span("stem") is not tracing._OFF
    assert tracing.span("stem") is tracing._OFF
    assert tracing.span("post", frames=3) is tracing._OFF


@pytest.mark.parametrize("kind", ["dyyolo", "dysoem", "rtm"])
def test_cut_at_spans_marks_every_section_boundary(detectors, kind):
    """A call under ``cut_at_spans`` reports each section as it starts and,
    at its end, the return to the span around it (detect's own work, and
    after detect none): where a capture cuts one graph per section. Spans
    are still recorded where tracing is on."""
    cuts = []
    with tracing.collect() as t, tracing.cut_at_spans(
            lambda name, frames: cuts.append(name)):
        detectors[kind](_frames())
    want = ["detect"]
    for name in SECTIONS[kind]:
        want += [name, "detect"]
    assert cuts == want + [None]
    assert [s.name for s in t.spans] == ["detect"] + SECTIONS[kind]
    with pytest.raises(RuntimeError):
        with tracing.cut_at_spans(print), tracing.cut_at_spans(print):
            pass


def test_count_goes_into_the_trace_counts():
    tracing.count("graph_replay", 4)
    with tracing.collect() as t:
        tracing.count("graph_replay", 4)
        tracing.count("graph_replay", 4)
        tracing.count("graph_eager")
    assert t.spans == []
    assert t.counts == {"graph_replay": {"calls": 2, "frames": 8},
                        "graph_eager": {"calls": 1, "frames": 0}}


def test_a_capture_keeps_the_cached_tables_it_read():
    """Inside ``kept_tables()`` every table a call takes from the bounded
    caches (the resize matrices, the decode's head tables) is kept, and
    stays held after its cache dropped it; outside nothing is kept."""
    from uavdet_tpu_torch.inference import _head_tables
    from uavdet_tpu_torch.ops.resize import _weights_on, bilinear_resize
    from uavdet_tpu_torch.utils.tables import kept_tables
    x = torch.rand(1, 48, 40, 3)
    with kept_tables() as kept:
        y = bilinear_resize(x, 32, 32)
    assert [tuple(t.shape) for t in kept] == [(48, 32), (40, 32)]
    _weights_on.cache_clear()
    fresh = _weights_on(x.device, x.dtype, 48, 32)
    assert fresh is not kept[0] and torch.equal(fresh, kept[0])
    assert torch.equal(bilinear_resize(x, 32, 32), y) and len(kept) == 2
    model, hp = _model("dyyolo")
    detect = make_detector(model, hp, SIZE, compute_dtype=torch.float32)
    with kept_tables() as kept:
        detect(_frames())
    assert any(isinstance(t, dict) for t in kept)   # _head_tables's
    assert _head_tables.cache_info().currsize >= 1
