"""The port's bench (``uavdet_tpu_torch/bench.py``) on the CPU.

Every cell at ``--smoke`` size prints one JSON line; the timed callables
of the default cell and cfg6 compute what the JAX package computes as the
repository's ``bench.py`` composes it (the weights carried across by
``utils/weights.py``); the reference-structure baseline detects what the
port's detector detects, so ``vs_baseline`` compares one function. cfg4's
callable is ``make_rtm_detector``, which
``tests/test_torch_rtm.py::test_rtm_detector_matches_bench_detect`` holds
against ``bench.py``'s cfg4 detect (its JAX compile would take this file
past a minute).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uavdet_tpu.inference import make_detector as jax_make_detector
from uavdet_tpu.models import build_model as jax_build_model
from uavdet_tpu.training import build_optimizer as jax_build_optimizer
from uavdet_tpu.training import init_state as jax_init_state
from uavdet_tpu.training import make_train_step as jax_make_train_step
from uavdet_tpu.utils.datatypes import BatchData as JaxBatch
from uavdet_tpu_torch import bench, kernels
from uavdet_tpu_torch.utils.timing import time_total
from uavdet_tpu_torch.utils.weights import load_flax_variables

SMOKE = ["--smoke", "--device", "cpu"]
CASES = {"default": [], **{f"cfg{n}": ["--config", str(n)]
                           for n in range(1, 7)},
         "host-data": ["--host-data", "--epochs", "1"],
         "fit-rate": ["--fit-rate"]}
# the JAX bench's labels (at smoke size) plus " [torch]"; the training
# cells' fold flags as the JAX bench's unfolded runs read
LABELS = {
    "default": "fps/chip end-to-end (preproc+detect+NMS) DyYOLO @ 64px bs=2",
    "cfg1": "fps/chip end-to-end (preproc+detect+NMS) baseline @ 64px bs=2 "
            "[cfg1 rgb]",
    "cfg2": "fps/chip end-to-end (dual-preproc+detect+NMS) DyYOLO @ 64px "
            "2x2 native-res frames [cfg2 rgb+ir dual-stream]",
    "cfg3": "fps/chip end-to-end (preproc+detect+NMS) DySOEM_SimFPN @ 48px "
            "bs=2 [cfg3 ir thermal]",
    "cfg4": "fps/chip RTMUAVDet pipeline (preproc+detect+NMS) @ 64px bs=2",
    "cfg5": "RTMUAVDet train fwd+bwd imgs/s @ 64px bs=2 fold=False",
    "cfg6": "DyYOLO train fwd+bwd imgs/s @ 64px bs=2 accum=2 "
            "fold_early=False",
    "host-data": "fps end-to-end WITH host data path (jpeg decode->detect) "
                 "DyYOLO @ 64px bs=2 over 1 epochs [host-bound]",
    "fit-rate": "Trainer.fit sustained img/s (cached device batches) DyYOLO "
                "@64px bs=2 accum=2 fold_early=False",
}
WITH_BASELINE = ("default", "cfg1", "cfg2")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: at these sizes torch's CPU threads cost more
    than they give, and the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cell_of(*args):
    return bench.build_cell(bench.parse_args([*args, *SMOKE]))


@pytest.mark.parametrize("case", list(CASES))
def test_smoke_prints_one_json_line(case, capsys):
    assert bench.main([*CASES[case], *SMOKE]) == 0
    captured = capsys.readouterr()
    lines = captured.out.strip().splitlines()
    assert len(lines) == 1, captured.out
    line = json.loads(lines[0])
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["unit"] == "fps" and line["value"] > 0
    assert line["metric"] == LABELS[case] + " [torch]"
    if case in WITH_BASELINE:
        assert line["vs_baseline"] > 0
    else:
        assert line["vs_baseline"] is None
    assert "launches: " in captured.err


def test_default_cell_matches_jax():
    """The default cell's callable against ``make_detector`` over
    ``model.apply`` (``bench.py:62-86``) on the same uint8 frames."""
    cell = cell_of()
    hp = bench._smoke_hparams("DyYOLO")
    jm = jax_build_model("DyYOLO", hp, dtype=jnp.float32)
    v = jm.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)), train=False)
    load_flax_variables(cell.model, v)
    got = cell.run()
    want = jax_make_detector(jm, hp, 64, pre_nms_topk=256,
                             compute_dtype=jnp.float32)(
        v, jnp.asarray(cell.inputs[0].numpy()))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert 0 < int(got.valid.sum())
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-4, atol=1e-7)


def test_dyyolo_train_cell_matches_jax():
    """cfg6's callable: one microbatch's loss against the JAX train step
    (``fold_early=False``) on ``bench.py:261-267``'s batch."""
    cell = cell_of("--config", "6")
    hp = bench._smoke_hparams("DyYOLO")
    jm = jax_build_model("DyYOLO", hp)
    tx = jax_build_optimizer(hp, grad_batches=2)
    state = jax_init_state(jm, tx, jax.random.key(0), 64, batch_size=2)
    load_flax_variables(cell.model, {"params": state.params,
                                     "batch_stats": state.batch_stats})
    loss = float(cell.run())
    step = jax_make_train_step(jm, tx, hp, 64, fold_early=False)
    _, metrics = step(state, JaxBatch(*(jnp.asarray(t.numpy())
                                        for t in cell.inputs[0])))
    np.testing.assert_allclose(loss, float(metrics["loss"]), rtol=1e-5)


@pytest.mark.parametrize("config", [None, 1, 2])
def test_reference_structure_detects_what_the_port_detects(config):
    """The baseline of ``vs_baseline``: the reference's module structure
    holding the port model's weights, behind the port's decode and NMS,
    gives the port detector's detections (float32)."""
    cell = cell_of(*([] if config is None else ["--config", str(config)]))
    got, want = cell.reference()(), cell.run()
    np.testing.assert_array_equal(got.valid.numpy(), want.valid.numpy())
    assert 0 < int(want.valid.sum())
    np.testing.assert_allclose(got.scores.numpy(), want.scores.numpy(),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(got.boxes.numpy(), want.boxes.numpy(),
                               rtol=1e-4, atol=1e-3)


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--smoke"])


def test_a_path_kernel_without_launches_fails():
    """On the card a cell whose path kernel counted no launch raises; on
    the CPU the counts are only reported."""
    kernels.reset_launch_counts()
    bench._check_launches(("nms",), 1, torch.device("cpu"))
    with pytest.raises(RuntimeError, match="nms"):
        bench._check_launches(("nms",), 1, torch.device("cuda"))


def test_time_total_times_iters_after_warmup():
    calls = []
    seconds = time_total(lambda: calls.append(1), 5, 2, "cpu")
    assert len(calls) == 7 and seconds >= 0


def test_params_are_params_yaml():
    """The bench's constants for params.yaml (the card has no PyYAML)."""
    import yaml
    with open(Path(__file__).parents[1] / "params.yaml") as f:
        params = yaml.safe_load(f)
    assert params["model"]["name"] == bench.PARAMS["model"]
    assert params["train"]["seed"] == bench.PARAMS["seed"]
    assert params["dataset"]["workers"] == bench.PARAMS["workers"]
    hp, want = params["model"]["hparams"], bench.HPARAMS["DyYOLO"]
    assert [list(t) for t in want.layer_config] == hp["layer_config"]
    assert [[list(a) for a in h] for h in want.anchors] == hp["anchors"]
