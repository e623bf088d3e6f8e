"""The port's debug guards (``utils/debug.py``) and the rest of its
``utils/viz.py`` (``summarize_model``, ``plot_sample_data``), on the CPU."""

from typing import NamedTuple

import numpy as np
import pytest
import torch

from tests.test_torch_model import TINY_CFG
from uavdet_tpu_torch.models import DyYOLO
from uavdet_tpu_torch.utils.datatypes import BatchData, Detections
from uavdet_tpu_torch.utils.debug import (assert_finite, checked,
                                          enable_nan_debugging)
from uavdet_tpu_torch.utils.viz import plot_sample_data, summarize_model


class Pair(NamedTuple):
    a: object
    b: object


def test_enable_nan_debugging_toggles_anomaly_mode():
    before = torch.is_anomaly_enabled()
    try:
        enable_nan_debugging()
        assert torch.is_anomaly_enabled()
        enable_nan_debugging(False)
        assert not torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(before)


def test_enable_nan_debugging_names_the_op_of_a_nan_gradient():
    x = torch.tensor([-1.0], requires_grad=True)
    try:
        enable_nan_debugging()
        with pytest.raises(RuntimeError, match="SqrtBackward0"):
            torch.sqrt(x).sum().backward()
    finally:
        enable_nan_debugging(False)


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf")])
def test_assert_finite_names_the_leaf(bad):
    tree = {"loss": torch.tensor(1.0),
            "parts": [np.zeros(3), Pair(a=torch.ones(2),
                                        b=torch.tensor([0.0, bad]))],
            "step": torch.tensor(3)}
    with pytest.raises(FloatingPointError,
                       match=r"state\['parts'\]\[1\]\.b"):
        assert_finite(tree, "state")
    tree["parts"][1] = Pair(a=torch.ones(2), b=torch.zeros(2))
    assert_finite(tree, "state")
    # integer leaves are never non-finite; a float array is read too
    assert_finite((torch.tensor([2 ** 62]), np.arange(3)))
    with pytest.raises(FloatingPointError, match=r"x\[1\]"):
        assert_finite((np.ones(2), np.array([np.nan])), "x")


def test_checked_raises_on_a_non_finite_output():
    def detect(x):
        return Detections(boxes=torch.zeros((1, 4)),
                          scores=x.sum(-1, keepdim=True), valid=x > 0)

    safe = checked(detect)
    assert safe.__name__ == "detect"
    out = safe(torch.ones(2))
    assert torch.equal(out.scores, torch.tensor([2.0]))
    with pytest.raises(FloatingPointError, match="output of detect.scores"):
        safe(torch.tensor([1.0, float("inf")]))


def test_summarize_model():
    model = DyYOLO(TINY_CFG).eval()
    table = summarize_model(model, (1, 64, 64, 3))
    lines = table.splitlines()
    total = sum(p.numel() for p in model.parameters())
    assert lines[-1] == f"total parameters: {total}"
    rows = {line.split()[0]: line.split() for line in lines[1:-1]}
    # a DyConv holds its experts itself; its first conv of the tail
    assert rows["layers.0"][1] == "DyConvModule"
    assert rows["layers.0"][-1] == str(model.layers[0].weights.numel())
    assert rows["layers.1.conv"][2:-1] == ["(1,", "16,", "32,", "32)"]
    assert sum(int(r[-1]) for r in rows.values()) == total


def test_plot_sample_data(rng, tmp_path):
    batches = [BatchData(
        image=torch.from_numpy(rng.uniform(size=(2, 32, 32, 3))
                               .astype(np.float32)),
        boxes=torch.tensor([[[0.1, 0.1, 0.5, 0.6], [0, 0, 0, 0]]] * 2),
        box_mask=torch.tensor([[True, False]] * 2)) for _ in range(3)]
    out = plot_sample_data(batches, str(tmp_path / "samples.png"), n=2)
    assert out == str(tmp_path / "samples.png")
    assert (tmp_path / "samples.png").stat().st_size > 1000
