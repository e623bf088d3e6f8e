"""The port's roofline table and section probes (``roofline_table``,
``section_probe`` and ``cfg3_section_probe`` in ``uavdet_tpu_torch/scripts``)
against the JAX package's ``scripts/roofline_table.py`` and models, on the
CPU.

The port's walk must give the JAX walk's rows exactly (the same float
arithmetic in the same order), and its section of each token the JAX walk's
label. A sectioned call runs the detector's own modules in order, so its
heads and Detections are bitwise those of ``Detector.heads`` and
``detect``; against the JAX models the f32 sums associate differently, so
heads agree to rtol 1e-4 (atol 1e-4 of the head's largest value).
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tests.test_torch_detector import SmallHP
from tests.test_torch_dysoem import _models
from tests.test_torch_model import TINY_CFG, models_for
from uavdet_tpu.models import dysoem_simfpn as jax_dysoem
from uavdet_tpu.ops.pallas_stem_split import \
    detector_stem_fast_path as jax_stem_fast_path
from uavdet_tpu_torch.inference import Detector, make_detector
from uavdet_tpu_torch.models import DYSOEM, DYYOLO, DySOEM_SimFPN, DyYOLO
from uavdet_tpu_torch.models.dysoem_simfpn import DynamicSOEM
from uavdet_tpu_torch.scripts import roofline_table
from uavdet_tpu_torch.scripts.cfg3_section_probe import sectioned_dysoem
from uavdet_tpu_torch.scripts.section_probe import sectioned_dyyolo
from uavdet_tpu_torch.utils.seeding import init_weights
from uavdet_tpu_torch.utils.weights import load_flax_variables

REPO = Path(__file__).resolve().parents[1]

# the smallest layer_config with all four sections: the stem tokens, the
# 256- and 512-channel stride-2 cuts, two heads (SmallHP's anchors)
SECTION_CFG = (("DyConv", 32, 3, 1), ("DyConv", 64, 3, 2), ("B", 1),
               (128, 3, 2), (256, 3, 2), ("B", 8), (512, 3, 2), ("B", 1),
               (256, 3, 1), ("S",), ("U",), (128, 1, 1), (256, 3, 1),
               ("S",))


@pytest.fixture(scope="module")
def jax_walk():
    spec = importlib.util.spec_from_file_location(
        "jax_roofline_table", REPO / "scripts" / "roofline_table.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    here = os.getcwd()
    os.chdir(REPO)   # the JAX walk reads params.yaml from the working dir
    try:
        yield module.walk
    finally:
        os.chdir(here)


@pytest.mark.parametrize("batch,size", [(16, 640), (2, 320), (1, 64)])
def test_walk_equals_jax_walk(jax_walk, batch, size):
    """Row for row: section, name, FLOPs and real bytes, exactly."""
    want = jax_walk(batch, size)
    got = roofline_table.walk(batch, size)
    assert len(got) == len(want)
    for g, (sec, name, flops, real, _) in zip(got, want):
        assert (g.section, g.name, g.flops, g.bytes) == \
            (sec, name, flops, real)


def test_token_sections_are_the_jax_walks_labels(jax_walk):
    """The section of each token, as the probe cuts the tail, is the JAX
    walk's label of every row that token prices; and every section is one
    run of tokens, the stem the two kernel tokens."""
    labels = roofline_table.token_sections(DYYOLO.layer_config)
    rows = roofline_table.walk(16, 640)
    for row, want in zip(rows, jax_walk(16, 640), strict=True):
        assert labels[row.token] == want[0]
    assert {r.token for r in rows} == set(range(len(labels)))
    assert labels[:3] == ["stem", "stem", "early"]
    runs = [s for i, s in enumerate(labels) if i == 0 or labels[i - 1] != s]
    assert runs == list(roofline_table.SECTIONS)
    # the cuts: through the 256-s2 conv, through the 512-s2 conv
    assert labels[DYYOLO.layer_config.index((256, 3, 2))] == "early"
    assert labels[DYYOLO.layer_config.index((256, 3, 2)) + 1] == "mid"
    assert labels[DYYOLO.layer_config.index((512, 3, 2))] == "mid"
    assert labels[DYYOLO.layer_config.index((512, 3, 2)) + 1] == "deep"


def test_section_floors_at_the_default_cell():
    """DyYOLO at (16, 640) on the data sheet's peaks: the totals the JAX
    walk gives (2470.9 GFLOP), the stem's floor that of kernels A and B's
    two convs."""
    t = roofline_table.totals(roofline_table.walk(16, 640))
    assert round(sum(s["gflop"] for s in t.values()), 1) == 2470.9
    floors = roofline_table.section_floors(16, 640)
    assert list(floors) == list(roofline_table.SECTIONS)
    assert [round(floors[s], 3) for s in floors] == [0.325, 0.559, 0.737,
                                                     1.646]
    assert round(sum(floors.values()), 2) == 3.27


def test_soem_walk_prices_the_models_convs(rng):
    """The FLOPs of each section of ``soem_walk`` are those of the convs
    the port's DySOEM_SimFPN runs on frames of that size, read from its
    modules by forward hooks (each SOEM a conv of its mixed 3x3 kernel on
    the space-to-depth'd input)."""
    model = init_weights(DySOEM_SimFPN(), 0).eval()
    flops = {}
    section = {}
    for name, m in model.named_modules():
        top = name.split(".")[0]
        section[m] = ("front" if top == "input_stem" else
                      top if top.startswith("soem_") else "neck+head")

    def hook(m, args, out):
        if isinstance(m, DynamicSOEM):
            out = out[0] if isinstance(out, tuple) else out   # emit_gap
            b, h, w, co = out.shape
            cin = m.experts.kernel.shape[2]
            n = 2.0 * b * h * w * co * cin * 9
        elif isinstance(m, torch.nn.Conv2d):
            b, co, h, w = out.shape
            kh, kw = m.kernel_size
            n = 2.0 * b * h * w * co * m.in_channels * kh * kw
        else:
            return
        flops[section[m]] = flops.get(section[m], 0.0) + n

    for m in model.modules():
        m.register_forward_hook(hook)
    b, size = 2, 64
    with torch.no_grad():
        model(torch.from_numpy(rng.uniform(size=(b, size, size, 3))
                               .astype(np.float32)))
    t = roofline_table.totals(roofline_table.soem_walk(b, size))
    assert list(t) == list(roofline_table.SOEM_SECTIONS)
    for sec, got in t.items():
        assert got["gflop"] * 1e9 == pytest.approx(flops[sec], rel=1e-12)
    floors = roofline_table.soem_section_floors(32, 1280)
    # kernel D's bound per site in chip_smoke.py: 1.93 TFLOP at the peak
    for i in range(3):
        assert floors[f"soem_{i}"] == pytest.approx(
            2.0 * 32 * 640 * 640 * 64 * 128 * 9 / 989.4e12 * 1e3)


@pytest.fixture(scope="module")
def section_models():
    """(flax model, flax variables, the port's DyYOLO loaded from them by
    utils/weights.py) of SECTION_CFG."""
    jm, v, _ = models_for(SECTION_CFG, 31)
    port = DyYOLO(SECTION_CFG, attn_temperature=30.0).eval()
    load_flax_variables(port, v)
    return jm, v, port


def _same_heads(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g.bbox, w.bbox) and torch.equal(g.obj, w.obj)


def _heads_close(got, want):
    """rtol 1e-4, atol 1e-4 of the head's largest |value|, per field."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for field in ("bbox", "obj"):
            gv = getattr(g, field).float().numpy()
            wv = np.asarray(getattr(w, field), np.float32)
            assert gv.shape == wv.shape
            np.testing.assert_allclose(gv, wv, rtol=1e-4,
                                       atol=1e-4 * np.abs(wv).max())


def _same_detections(got, want):
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)


def test_sectioned_dyyolo_is_the_detector(rng, section_models):
    """f32 at 64 px: the sectioned call's heads are bitwise
    ``Detector.heads``', its Detections bitwise ``detect``'s; the marks
    come in the sections' order. Against JAX: the stem section against the
    Pallas stem in interpret mode (bf16 out; the f32 sums associate
    differently, so a rare element moves by one bf16 ulp), and the heads
    against the JAX tail's ``apply`` on the port's stem output."""
    jm, v, port = section_models
    frames = torch.from_numpy((rng.uniform(size=(2, 64, 64, 3)) * 255)
                              .astype(np.uint8))
    kw = dict(compute_dtype=torch.float32, pre_nms_topk=128, max_det=50)
    det = Detector(port, SmallHP, 64, **kw)
    names, run = sectioned_dyyolo(det)
    assert names == ["stem", "early", "mid", "deep", "post"]
    seen = []
    with torch.inference_mode():
        heads, dets = run(frames, seen.append)
        _same_heads(heads, det.heads(frames))
        stem_out = det.stem.stem(frames)
    assert seen == names
    _same_detections(dets, make_detector(port, SmallHP, 64, **kw)(frames))
    assert dets.valid.sum() > 10

    stem_fn, tail_model, tail_vars = jax_stem_fast_path(
        jm, v, SECTION_CFG, 30.0, interpret=True)
    want_stem = np.asarray(stem_fn(jnp.asarray(frames.numpy()))
                           .astype(jnp.float32))
    got_stem = stem_out.float().numpy()
    np.testing.assert_allclose(got_stem, want_stem, rtol=2 ** -7, atol=1e-6)
    assert (got_stem == want_stem).mean() > 0.999
    want = tail_model.apply(tail_vars, jnp.asarray(got_stem), train=False)
    _heads_close(heads, want)


def test_sectioned_dyyolo_needs_the_sections():
    """A model without the stem tokens, or without a 512-channel cut, is
    refused by name."""
    with pytest.raises(ValueError, match="stem tokens"):
        sectioned_dyyolo(Detector(DyYOLO(TINY_CFG).eval(), SmallHP, 64))
    no_deep = SECTION_CFG[:6] + SECTION_CFG[7:]
    with pytest.raises(ValueError, match="sections"):
        sectioned_dyyolo(Detector(DyYOLO(no_deep).eval(), SmallHP, 64))


def test_sectioned_dysoem_is_the_detector(rng):
    """A DySOEM_SimFPN loaded from flax variables by utils/weights.py, f32
    at 64 px: the sectioned call's heads bitwise ``forward``'s and
    ``Detector.heads``', its Detections bitwise ``detect``'s, its heads
    within rtol 1e-4 of the JAX model's ``apply``."""
    v, _ = _models(5)
    port = DySOEM_SimFPN().eval()
    load_flax_variables(port, v)
    frames = torch.from_numpy((rng.uniform(size=(2, 64, 64, 3)) * 255)
                              .astype(np.uint8))
    det = Detector(port, DYSOEM, 64, compute_dtype=torch.float32)
    names, run = sectioned_dysoem(det)
    assert names == ["front", "soem_0", "soem_1", "soem_2", "neck+head",
                     "post"]
    seen = []
    with torch.inference_mode():
        heads, dets = run(frames, seen.append)
        x = det.prepare(frames)
        _same_heads(heads, port(x))
        _same_heads(heads, det.heads(x))
    assert seen == names
    _same_detections(dets, make_detector(port, DYSOEM, 64,
                                         compute_dtype=torch.float32)(frames))
    want = jax_dysoem.DySOEM_SimFPN().apply(v, jnp.asarray(x.numpy()),
                                            train=False)
    _heads_close(heads, want)


@pytest.mark.parametrize("module,args,sections", [
    ("roofline_table", ["--batch", "2", "--size", "64", "--per-layer"],
     roofline_table.SECTIONS),
    ("section_probe", ["--device", "cpu", "--batch", "1", "--input", "64",
                       "--iters", "2", "--warmup", "1"],
     (*roofline_table.SECTIONS, "post")),
    ("cfg3_section_probe", ["--device", "cpu", "--batch", "1", "--input",
                            "64", "--iters", "2", "--warmup", "1"],
     (*roofline_table.SOEM_SECTIONS, "post"))])
def test_main_runs_on_the_cpu(module, args, sections):
    """``python -m uavdet_tpu_torch.scripts.<module>`` at a tiny size exits
    0 and prints a row of its table for every section; a probe's sectioned
    calls agree bitwise with the detector's."""
    res = subprocess.run(
        [sys.executable, "-m", f"uavdet_tpu_torch.scripts.{module}", *args],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    for sec in sections:
        assert any(ln.split()[:1] == [sec] for ln in lines), (sec, lines)
    if module != "roofline_table":
        assert "heads bitwise equal to Detector.heads: True; Detections " \
               "bitwise equal to detect's: True" in res.stdout
        assert "device: cpu" in res.stdout


def test_probes_need_a_card_unless_told_otherwise(monkeypatch):
    """Without a visible CUDA device the default (--device cuda) refuses
    to run; it does not fall back to the CPU."""
    from uavdet_tpu_torch.scripts import cfg3_section_probe, section_probe
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for probe in (section_probe, cfg3_section_probe):
        with pytest.raises(SystemExit, match="no CUDA device"):
            probe.main([])
