"""The ``rtm_uav_det`` configuration and its cell ``rtm_serve_b8``: the plain
reference (``reference/rtm_uav_det.py``) against the port's ``RTMUAVDet`` in
float32 on the CPU, its upsample against the port's bilinear resize, the
cell's run on the CPU at small sizes (correct; not correct under each planted
fault; the float8 control beyond the limits), the walk against a count of
the reference's products, the readers of the cell's new metrics, and on the
card the limits at a reduced size and the spans' coverage of a call."""

import json
from pathlib import Path

import pytest
import torch

from perfbench import compare, run, spans, walks
from perfbench.drive import cell_class, entry, reference_model
from perfbench.faults import FAULTS
from perfbench.reference import detect as ref_detect
from perfbench.reference import rtm_uav_det as ref_rtm
from perfbench.tests.helpers import cell_parts, run_tiny
from perfbench.weights import _specs, seeded_state

BENCH = Path(__file__).resolve().parents[1]
CELL = "rtm_serve_b8"
CONFIG = json.loads((BENCH / "configs" / "rtm_uav_det.json").read_text())
SEED = 2 ** 31 + 5
SIZE, BATCH = 64, 2
# float32 on both sides: the logits of 30-odd layers agree to 1e-5 and the
# boxes, up to about 2,500 px wide, to 1e-3 px (float32's rounding of their
# sums); the port in bf16 misses by about 0.03 logit and 9 px
LOGIT_TOL, BOX_TOL_PX = 1e-3, 0.05


def _port_and_reference(seed: int):
    from uavdet_tpu_torch.models.rtm_uav_det import (RTMUAVDet,
                                                     rtm_det_scales)
    ref = reference_model(CONFIG, "cpu")
    state = seeded_state(reference_model(CONFIG, "meta"), seed, "cpu")
    ref.load_state_dict(state)
    scales = rtm_det_scales(SIZE)
    anchors = [[[a / (SIZE // s) for a in anchor] for anchor in head]
               for head, s in zip(CONFIG["hparams"]["anchors"], scales)]
    port = RTMUAVDet(anchors, det_scales=scales)
    port.load_state_dict(state)
    return port.eval(), ref.eval(), scales


def _gaps(port, ref, scales, x) -> tuple:
    """The largest |logit| and box (px) differences of every candidate of
    the port's heads against the reference's."""
    from uavdet_tpu_torch.inference import rtm_candidates
    with torch.no_grad():
        cand = ref_detect.candidates(ref(x), CONFIG["hparams"]["anchors"],
                                     SIZE, 512)
        boxes, scores = rtm_candidates(port(x), SIZE, scales)
    logits = torch.logit(scores.double()).float()
    return (float((logits - cand["logits"]).abs().max()),
            float((boxes - cand["boxes"]).abs().max()))


@pytest.mark.parametrize("seed", [SEED, 3400000001])
def test_reference_agrees_with_the_port_in_float32(seed):
    torch.set_num_threads(4)
    port, ref, scales = _port_and_reference(seed)
    x = torch.rand((BATCH, SIZE, SIZE, 3),
                   generator=torch.Generator().manual_seed(seed))
    logit, box = _gaps(port, ref, scales, x)
    assert logit < LOGIT_TOL and box < BOX_TOL_PX
    logit, box = _gaps(port.to(torch.bfloat16), ref, scales, x)
    assert logit > LOGIT_TOL and box > BOX_TOL_PX


def test_the_reference_declares_the_ports_own_draws():
    """``utils/seeding.py:init_weights`` for RTMUAVDet: each MDyConv's filter
    layer N(0, 0.02) and scale layer N(0, 0.1), an objectness prior of 0.01;
    the rest by the harness's rules; the heads' convs N(0, 0.01), RTMDet's
    (``init_weights``: 0.1, which saturates scores at 640 px)."""
    spec = _specs(reference_model(CONFIG, "meta"))
    mdy = "neck.encoder_x1.mdy_conv_5x5."
    assert spec[mdy + "kernel_fc.weight"] == ("normal", 0.02)
    assert spec[mdy + "channel_fc.weight"] == ("normal", 0.1)
    assert spec[mdy + "attention.weight"][0] == "normal"
    assert spec[mdy + "base.bn.running_var"] == ("uniform", 0.8, 1.2)
    assert spec["neck.encoder_x2.group_norm_out.weight"] == ("uniform", 0.8,
                                                             1.2)
    for h in range(2):
        assert spec[f"head.obj_{h}.bias"][1] == pytest.approx(-4.59512, 1e-5)
        assert spec[f"head.bbox_{h}.weight"] == ("normal", 0.01)


@pytest.mark.parametrize("shape", [(2, 5, 8, 8), (1, 3, 7, 12)])
def test_the_upsample_is_the_ports_bilinear_resize(shape):
    from uavdet_tpu_torch.ops.resize import bilinear_resize
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    _, _, h, w = shape
    port = bilinear_resize(x.permute(0, 2, 3, 1), 2 * h, 2 * w)
    assert torch.allclose(ref_rtm.upsample2(x), port.permute(0, 3, 1, 2),
                          rtol=0, atol=1e-6)


def test_a_sound_detector_is_correct(monkeypatch, capsys):
    line = run_tiny(monkeypatch, capsys, CELL)
    assert line["correct"] is True
    assert set(line["metrics"]) == {"frames_per_s", "setup_s"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_detector_is_not_correct(monkeypatch, capsys, fault):
    mod = entry(CONFIG["entry"])
    monkeypatch.setattr(mod, "build", FAULTS[fault](mod.build))
    assert run_tiny(monkeypatch, capsys, CELL)["correct"] is False


def test_the_control_reads_beyond_the_limits():
    """The reference in float8 in the program's place, on every distinct
    batch of the tiny mix: beyond a limit of the cell on each."""
    torch.set_num_threads(4)
    config, mix = cell_parts(CELL)
    lims = compare.limits(CELL)
    c = cell_class(mix["kind"])(config, mix, SEED, "cpu")
    c.inputs()
    for p in c.control():
        assert any(p[k] > lims[k] for k in lims)


def test_the_walk_counts_every_product_of_the_reference():
    """At (2, 64): the walk's FLOPs equal the reference's conv, linear and
    per-sample filter products, counted by forward hooks at the shapes the
    forward ran."""
    ref = reference_model(CONFIG, "cpu")
    ref.load_state_dict(seeded_state(reference_model(CONFIG, "meta"), SEED,
                                     "cpu"))
    counted = []

    def hook(m, args, out):
        if isinstance(m, torch.nn.Conv2d):
            k = m.in_channels // m.groups * m.kernel_size[0] \
                * m.kernel_size[1]
        elif isinstance(m, torch.nn.Linear):
            k = m.in_features
        else:
            k = args[1].shape[-1] * args[1].shape[-2]
        counted.append(2.0 * out.numel() * k)

    for m in ref.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear,
                          ref_rtm.SpatialFilter)):
            m.register_forward_hook(hook)
    with torch.no_grad():
        ref(torch.rand((BATCH, SIZE, SIZE, 3)))
    rows = walks.rows(CONFIG, BATCH, SIZE)
    assert len(counted) == sum(r.flops > 0 for r in rows)
    assert sum(counted) == walks.flops(CONFIG, BATCH, SIZE)


def test_walk_total():
    assert walks.flops(CONFIG, 8, 640) / 1e9 == pytest.approx(306.5,
                                                              abs=0.1)


SECTIONS = ["stem", "csp", "fuse", "norm", "mdy", "mlp", "head", "post"]
DEVICE_METRICS = ["csp_device_ms.rtm", "fuse_device_ms.rtm",
                  "norm_device_ms.rtm", "mdy_device_ms.rtm",
                  "mlp_device_ms.rtm", "post_device_ms.rtm"]


def test_the_readers_on_the_cpu():
    """Host ms of every section from the host slice; no device ms and no
    share of a peak without a card; the issue time from the context."""
    torch.set_num_threads(4)
    config, mix = cell_parts(CELL)
    ctx = {"config": config, "traffic": dict(mix, issue_calls=3),
           "device_kind": "cpu", "issue_ms": [1.0, 3.0, 2.0],
           "window": {"rate": 100.0}}
    for name in DEVICE_METRICS + ["mfu.rtm"]:
        assert run.reader(name)(ctx) is None
    assert run.reader("host_issue_ms.rtm")(ctx) == 2.0
    host = ctx[spans.KEY]["host_ms"]
    assert all(host[s] > 0 for s in ["detect"] + SECTIONS)
    names = [m["name"] for m in run.metrics_of(run.load_benchmark(), CELL,
                                               "per_layer")]
    assert sorted(names) == sorted(DEVICE_METRICS + [
        "host_issue_ms.rtm", "device_idle.rtm", "mfu.rtm"])


@pytest.mark.card
def test_program_within_and_control_beyond_the_limits_on_the_card(card):
    """At a reduced size on the card (320 px, 4 frames): the program within
    every limit of the cell, the control (the reference in float8) beyond
    one."""
    config, mix = cell_parts(CELL)
    mix = dict(mix, size=320, batch=4)
    lims = compare.limits(CELL)
    c = cell_class(mix["kind"])(config, mix, SEED, card)
    c.setup()
    c.window(0.5)
    c.free()
    assert all(p[k] <= lims[k] for p in c.check() for k in lims)
    assert any(p[k] > lims[k] for p in c.control() for k in lims)


@pytest.mark.card
def test_the_spans_cover_the_call(card):
    """The sections' device ms and ``detect``'s own come to the profiled
    slice's busy ms within 2 %; ``detect``'s own is under 5 % of it."""
    _, _, config, mix = run.cell_entries(run.load_benchmark(), CELL)
    ctx = {"config": config, "traffic": mix,
           "device_kind": torch.cuda.get_device_name(card)}
    s = spans.of(ctx)
    dev = s["device_ms"]
    assert set(SECTIONS) <= set(dev)
    total = sum(dev[k] for k in SECTIONS) + dev.get("detect", 0.0)
    assert total == pytest.approx(s["busy_ms"], rel=0.02)
    assert dev.get("detect", 0.0) < 0.05 * s["busy_ms"]
