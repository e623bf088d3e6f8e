"""The readers of the program's spans (``spans.py``): the attribution of
device intervals and idle gaps to spans on synthetic events, every new
reader on a run context of each cell on the CPU (host ms found, device ms
left out), and on the card the coverage of a call by the spans."""

import pytest
import torch

from perfbench import run, spans
from perfbench.spans import Event
from perfbench.tests.helpers import cell_parts
from uavdet_tpu_torch.tracing import Span, Trace


def test_host_per_call_takes_the_median_call_and_own_time():
    ms = 1_000_000
    traces = []
    for whole, stem, soem in [(10, 2, 5), (20, 4, 6), (12, 3, 5)]:
        traces.append(Trace([Span("detect", 1, -1, 0, whole * ms, 2),
                             Span("stem", 1, 0, 0, stem * ms, None),
                             Span("soem", 1, 0, 0, soem * ms, None),
                             Span("soem", 1, 0, 0, 1 * ms, None)], {}))
    whole, own = spans.host_per_call(traces)
    assert whole == {"detect": 12, "stem": 3, "soem": 6}
    assert own["detect"] == 3 and own["soem"] == 6


def _call(t0, correlation):
    """A host call of a span ``detect`` holding ``stem`` and ``post`` with
    one operator each, which launches one kernel by a runtime call."""
    host = [Event("uavdet.detect", t0, t0 + 100),
            Event("uavdet.stem", t0 + 10, t0 + 40),
            Event("aten::conv", t0 + 12, t0 + 20, correlation),
            Event("cudaLaunchKernel", t0 + 14, t0 + 15, correlation + 1,
                  correlation),
            Event("uavdet.post", t0 + 50, t0 + 90),
            Event("aten::topk", t0 + 55, t0 + 58, correlation + 2),
            Event("cudaLaunchKernel", t0 + 56, t0 + 57, correlation + 3,
                  correlation + 2),
            Event("aten::where", t0 + 92, t0 + 95, correlation + 4)]
    device = [Event("uavdet.stem", t0 + 10, t0 + 60),   # the range's copy
              Event("conv_kernel", t0 + 30, t0 + 70, correlation + 1,
                    correlation),
              Event("topk_kernel", t0 + 80, t0 + 85, correlation + 3,
                    correlation + 2),
              # a launch the runtime call of which was not recorded: by the
              # operator it is linked to
              Event("where_kernel", t0 + 96, t0 + 99, 999_000 + t0,
                    correlation + 4)]
    return host, device


def test_attribute_by_correlation_to_the_innermost_span():
    host, device = _call(0, 1)
    h2, d2 = _call(1000, 11)
    out = spans.attribute(host + h2, device + d2
                          + [Event("memcpy", 2000, 2010, 77, 0)])
    assert set(out) == {"stem", "post", "detect", None}
    assert [(iv.name, iv.start_us) for iv in out["stem"]] == [
        ("conv_kernel", 30), ("conv_kernel", 1030)]
    assert [iv.name for iv in out["post"]] == ["topk_kernel"] * 2
    assert [iv.name for iv in out["detect"]] == ["where_kernel"] * 2
    assert [iv.name for iv in out[None]] == ["memcpy"]


def test_gaps_are_named_by_the_innermost_span_at_their_middle():
    host, device = _call(0, 1)
    device = [d for d in device if not d.name.startswith(spans.PREFIX)]
    # device busy 30-70, 80-85, 96-99: gaps 70-80 (middle 75: post, no
    # operator) and 85-96 (middle 90.5: detect, in no operator)
    assert spans.idle_by_span(device, host) == {"post": 10.0, "detect": 11.0}
    named = spans.name_gaps(device, host)
    assert named == [["uavdet.detect/python -> where_kernel",
                      pytest.approx(11e-6)],
                     ["uavdet.post/python -> topk_kernel",
                      pytest.approx(10e-6)]]
    s = spans.Spans(host)
    assert s.at(15).name == "uavdet.stem" and s.at(45).name == \
        "uavdet.detect" and s.at(120) is None


METRICS = {"dyyolo_serve_b16": ["tail_host_ms.serve", "post_host_ms.serve",
                                "tail_device_ms.serve",
                                "post_device_ms.serve"],
           "dysoem_ir_b32": ["front_device_ms.ir", "soem_device_ms.ir",
                             "neck_device_ms.ir", "post_device_ms.ir"],
           "dyyolo_cam_b1": ["stem_host_ms.cam", "tail_host_ms.cam",
                             "post_host_ms.cam"]}


def test_every_new_metric_of_the_benchmark_is_listed_here():
    bench = run.load_benchmark()
    for cell, names in METRICS.items():
        found = [m["name"] for m in run.metrics_of(bench, cell, "per_layer")]
        assert sorted(found[-len(names):]) == sorted(names)


@pytest.mark.parametrize("cell", sorted(METRICS))
def test_the_readers_on_the_cpu(cell):
    """Host ms from the host slice; no device ms without a card."""
    torch.set_num_threads(4)
    config, mix = cell_parts(cell)
    ctx = {"config": config, "traffic": dict(mix, issue_calls=3),
           "device_kind": "cpu", "issue_ms": [1.0]}
    for name in METRICS[cell]:
        value = run.reader(name)(ctx)
        if "_device_ms." in name:
            assert value is None
        else:
            assert value > 0
    assert ctx[spans.KEY]["host_ms"]["detect"] > 0


@pytest.mark.card
@pytest.mark.parametrize("cell, sections", [
    ("dyyolo_serve_b16", ["stem", "tail", "post"]),
    ("dysoem_ir_b32", ["front", "soem", "neck", "post"])])
def test_the_spans_cover_the_call(card, cell, sections):
    """The sections' device ms and ``detect``'s own come to the profiled
    slice's busy ms within 2 %; ``detect``'s own is under 5 % of it."""
    _, _, config, mix = run.cell_entries(run.load_benchmark(), cell)
    ctx = {"config": config, "traffic": mix,
           "device_kind": torch.cuda.get_device_name(card)}
    s = spans.of(ctx)
    dev = s["device_ms"]
    total = sum(dev[k] for k in sections) + dev.get("detect", 0.0)
    assert total == pytest.approx(s["busy_ms"], rel=0.02)
    assert dev.get("detect", 0.0) < 0.05 * s["busy_ms"]
