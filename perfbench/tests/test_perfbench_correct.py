"""What decides ``correct``, on the CPU at small sizes: the reference agrees
with the port, the control (the reference in float8 in the program's place)
comes out not correct, and a run with its timed path broken underneath
comes out with ``correct`` false, once for each fault a cell can have."""

import pytest
import torch

from perfbench import compare
from perfbench.drive import cell_class, entry
from perfbench.faults import FAULTS
from perfbench.tests.helpers import cell_parts, run_tiny

SEED = 2 ** 31 + 5


@pytest.mark.parametrize("cell", ["dyyolo_serve_b16", "dysoem_ir_b32"])
def test_reference_agrees_with_the_port_in_float32(cell):
    torch.set_num_threads(4)
    config, mix = cell_parts(cell)
    config = dict(config, dtype="float32")
    c = cell_class(mix["kind"])(config, mix, SEED, "cpu")
    c.setup()
    c.window(0.05)
    c.free()
    for numbers in c.check():
        assert numbers["logit_gap"] < 1e-3
        assert numbers["box_gap"] < 1e-3
        assert numbers["coverage_gap"] < 1e-3
        assert numbers["nms_overlap"] <= config["detector"]["nms_iou"]


@pytest.mark.parametrize("cell", ["dyyolo_serve_b16", "dysoem_ir_b32"])
def test_the_control_reads_far_above_the_program(cell):
    """At the CPU's small size the limits (set at the cells' sizes on the
    card) do not apply; the control's gaps read several times the
    program's on the same seed. The card test holds both to the limits."""
    torch.set_num_threads(4)
    config, mix = cell_parts(cell)
    c = cell_class(mix["kind"])(config, mix, SEED, "cpu")
    c.setup()
    c.window(0.05)
    c.free()
    prog, control = (_worst(p) for p in (c.check(), c.control()))
    assert control["logit_gap"] > 3 * prog["logit_gap"]
    assert control["box_gap"] > 3 * prog["box_gap"]


def _worst(parts: list) -> dict:
    return {k: max(p[k] for p in parts) for k in parts[0]}


@pytest.mark.parametrize("cell", ["dyyolo_serve_b16", "dyyolo_cam_b1",
                                  "dysoem_ir_b32"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_detector_is_not_correct(monkeypatch, capsys, cell, fault):
    if cell == "dyyolo_cam_b1" and fault == "half_batch":
        pytest.skip("the cell's batch of one frame has no half to leave out")
    mod = entry(cell_parts(cell)[0]["entry"])
    monkeypatch.setattr(mod, "build", FAULTS[fault](mod.build))
    assert run_tiny(monkeypatch, capsys, cell)["correct"] is False


def test_a_sound_detector_is_correct(monkeypatch, capsys):
    line = run_tiny(monkeypatch, capsys, "dyyolo_serve_b16")
    assert line["correct"] is True
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "host", "checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell", ["dyyolo_serve_b16", "dysoem_ir_b32",
                                  "dyyolo_cam_b1"])
def test_program_within_and_control_beyond_the_limits_on_the_card(card,
                                                                  cell):
    """At a reduced size on the card (320 px, 2 frames): the program within
    every limit of the cell, the control (the reference in float8) beyond
    one."""
    config, mix = cell_parts(cell)
    mix = dict(mix, size=320, batch=min(mix["batch"], 4))
    lims = compare.limits(cell)
    c = cell_class(mix["kind"])(config, mix, SEED, card)
    c.setup()
    c.window(0.5)
    c.free()
    assert all(p[k] <= lims[k] for p in c.check() for k in lims)
    assert any(p[k] > lims[k] for p in c.control() for k in lims)
