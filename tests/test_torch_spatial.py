"""The port's ``sp`` axis (``uavdet_tpu_torch/parallel/spatial.py``: bands
of image rows with halo-exchanged convs) on the CPU, against one process on
the whole images.

One two-rank and one four-rank gloo group (``parallel.dryrun.launch``) run
every check of the module (``tests/torch_sp_ep_worker.py:job``); each test
holds a part of the ranks' results against what this process computes.
The tiny DyYOLO of tests/test_models.py at 64 px (largest stride 16), a
DySOEM_SimFPN at 64 px, SGD with momentum, from the same seeded weights:

* train steps in float64 over two global batches of 4 on meshes (data,
  fsdp, sp, ep) of sp 2, sp 4 (16 rows a rank) and fsdp 2 x sp 2 under
  FSDP2 (HSDP: replicated over sp, sharded over fsdp; the composition the
  JAX package refuses for an XLA miscompile) equal one process: losses
  rtol 1e-5, the gradients of every update within 1e-6 of each tensor's
  largest (the bound of tests/test_parallel.py::
  test_sp_ep_grads_exact_at_f64), BatchNorm running statistics and the
  final parameters rtol 1e-5;
* the spatial detect (``make_detector(mesh=, spatial=True)``) of DyYOLO (4
  frames and one frame), of a DyYOLO with the stem of kernels A and B (its
  plain versions here: ``ops.stem.fused_stem_rows``), of BaselineModel, of
  the dual-stream DyYOLO and of DySOEM_SimFPN in float32 and in bfloat16
  (kernel D's plain version on halo'd bands) on sp 2, and of DyYOLO on
  data 2 x sp 2 (4 frames, and one frame: one sp group without rows)
  gathers the one-process detections: ``valid`` equal, boxes rtol 1e-5
  atol 1e-4, scores rtol 1e-5 atol 1e-6 (tests/test_parallel.py's); every
  rank exchanged halos, and ran the stem's two kernels once, or kernel D
  three times, on its band;
* ``conv2d_rows`` against the whole image's conv (3x3 of stride 1 and 2, a
  1x1 of stride 2), forward and backward, on both ranks: the image's two
  edges and a block boundary, at a stride-2 boundary too; the halo of the
  stem's frames on uint8;
* ``Trainer.fit`` with ``devices: 2``, ``sp_devices: 2`` equals one
  process's (validation loss, train loss rtol 1e-5, ``val_AP`` through the
  spatial detector).
"""

import copy
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests.test_torch_multihost import _trainer_config
from tests.test_torch_parallel import CFG, HP, noise_batches
from tests.test_torch_train_step import one_torch_thread  # noqa: F401
from tests.torch_dist_worker import ListPipe, run_steps
from tests.torch_sp_ep_worker import build
from uavdet_tpu_torch.inference import make_detector, make_rtm_detector
from uavdet_tpu_torch.models import DyYOLO
from uavdet_tpu_torch.models.baseline import BaselineModel
from uavdet_tpu_torch.models.dysoem_simfpn import DySOEM_SimFPN
from uavdet_tpu_torch.models.registry import DYSOEM
from uavdet_tpu_torch.parallel import (check_layout_supported, model_stride,
                                       row_band)
from uavdet_tpu_torch.parallel.dryrun import launch
from uavdet_tpu_torch.training import MetricsWriter, Trainer
from uavdet_tpu_torch.utils.config import Config
from uavdet_tpu_torch.utils.datatypes import BatchData
from uavdet_tpu_torch.utils.seeding import init_weights

SIZE = 64
F32, F64 = torch.float32, torch.float64
STEM_CFG = (("DyConv", 32, 3, 1), ("DyConv", 64, 3, 2)) + CFG[1:]
BASE_CFG = ((8, 3, 1),) + CFG[1:]
DHP = SimpleNamespace(**vars(DYSOEM))


def _weights(model, seed):
    return {k: v.clone() for k, v in init_weights(model, seed)
            .state_dict().items()}


def _detect_cases(rng):
    frames = (rng.uniform(size=(4, SIZE, SIZE, 3)) * 255).astype(np.uint8)
    dual = ((rng.uniform(size=(2, 96, 128, 3)) * 255).astype(np.uint8),
            (rng.uniform(size=(2, 64, 80, 3)) * 255).astype(np.uint8))
    dy = dict(kind="dyyolo", state_dict=_weights(
        DyYOLO(CFG, attn_temperature=30.0), 3), layer_config=CFG, hp=HP,
        size=SIZE)
    soem = dict(kind="dysoem", state_dict=_weights(DySOEM_SimFPN(), 6),
                hp=DHP, size=SIZE, frames=frames)
    two = (1, 1, 2, 1)
    return {
        "dyyolo": dict(dy, frames=frames, axes=two),
        "dyyolo_one_frame": dict(dy, frames=frames[:1], axes=two),
        "stem": dict(kind="dyyolo", state_dict=_weights(
            DyYOLO(STEM_CFG, attn_temperature=30.0), 4),
            layer_config=STEM_CFG, hp=HP, size=SIZE, frames=frames,
            axes=two),
        "baseline": dict(kind="baseline", state_dict=_weights(
            BaselineModel(BASE_CFG), 5), layer_config=BASE_CFG, hp=HP,
            size=SIZE, frames=frames, axes=two),
        "dual": dict(dy, dual=dual, axes=two),
        "dysoem": dict(soem, axes=two),
        "dysoem_bf16": dict(soem, dtype=torch.bfloat16, axes=two),
    }, {
        "data2_sp2": dict(dy, frames=frames, axes=(2, 1, 2, 1)),
        "data2_sp2_one_frame": dict(dy, frames=frames[:1],
                                    axes=(2, 1, 2, 1)),
    }


def _one_process_detect(c):
    dtype = c.get("dtype", F32)
    model = build(c["kind"], c["state_dict"], c.get("layer_config"))
    det = make_detector(model.to(dtype).eval(), c["hp"], c["size"],
                        compute_dtype=dtype, pre_nms_topk=64, max_det=16,
                        dual="dual" in c)
    got = det(*c["dual"]) if "dual" in c else det(c["frames"])
    return [t.numpy() for t in got]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """-> (the cases, this process's references, the two ranks' results,
    the four ranks' results)."""
    tmp = tmp_path_factory.mktemp("spatial")
    rng = np.random.default_rng(17)
    sd = _weights(DyYOLO(CFG, attn_temperature=30.0), 3)
    batches = noise_batches(rng, 2, 4)
    step = dict(kind="dyyolo", state_dict=sd, layer_config=CFG, hp=HP,
                size=SIZE, batches=batches)
    two_steps = {"sp2": dict(step, axes=(1, 1, 2, 1))}
    four_steps = {"sp4": dict(step, axes=(1, 1, 4, 1)),
                  "fsdp2_sp2": dict(step, axes=(1, 2, 2, 1), fsdp=True)}
    two_detect, four_detect = _detect_cases(rng)
    train = [BatchData(*b) for b in noise_batches(rng, 2, 4)]
    val = [BatchData(*b) for b in noise_batches(rng, 1, 4)]
    trainers = {"sp2": _trainer_config(tmp / "t_sp", devices=2,
                                       sp_devices=2)}
    two_spec = dict(steps=two_steps, detect=two_detect, halo_seed=3,
                    trainers=trainers, train=train, val=val,
                    workdir=str(tmp))
    four_spec = dict(steps=four_steps, detect=four_detect)
    with ThreadPoolExecutor(2) as ex:
        two = ex.submit(launch, "tests.torch_sp_ep_worker:job", 2,
                        args=(two_spec,), timeout=240)
        four = ex.submit(launch, "tests.torch_sp_ep_worker:job", 4,
                         args=(four_spec,), timeout=240)
        losses, grads, final, _ = run_steps(
            build("dyyolo", sd, CFG), HP, SIZE, batches, dtype=F64)
        refs = {"steps": {"losses": losses, "grads": grads,
                          "final": final}}
        refs["detect"] = {name: _one_process_detect(c) for name, c in
                          {**two_detect, **four_detect}.items()}
        refs["trainer"] = Trainer(
            Config(copy.deepcopy(_trainer_config(tmp / "t_one"))),
            ListPipe(train), ListPipe(val),
            metrics=MetricsWriter(str(tmp / "dv_one")), device="cpu").fit()
        cases = {**two_steps, **four_steps, **two_detect, **four_detect}
        return cases, refs, two.result(), four.result()


def _ranks(setup, name):
    return setup[2] if name in setup[2][0].get("steps", {}) or name in \
        setup[2][0].get("detect", {}) else setup[3]


def assert_step_equal(got, ref):
    """Losses rtol 1e-5; every update's gradients within 1e-6 of each
    tensor's largest; the BatchNorm running statistics and the final
    parameters rtol 1e-5."""
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    assert len(got["grads"]) == len(ref["grads"]) > 0
    for g, r in zip(got["grads"], ref["grads"]):
        for k, v in r.items():
            top = max(float(np.abs(v).max()), 1e-30)
            assert float(np.abs(g[k] - v).max()) / top < 1e-6, k
    for k, v in ref["final"].items():
        np.testing.assert_allclose(got["final"][k], v, rtol=1e-5, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("case", ["sp2", "sp4", "fsdp2_sp2"])
def test_sp_step_equals_one_process(setup, case):
    ranks = _ranks(setup, case)
    for rank in ranks:
        assert_step_equal(rank["steps"][case], setup[1]["steps"])
    a, b = (r["steps"][case]["final"] for r in ranks[:2])
    assert all(np.array_equal(a[k], b[k]) for k in a)
    sp = [r["steps"][case]["coordinate"][2] for r in ranks]
    assert sorted(set(sp)) == list(range(setup[0][case]["axes"][2]))
    # the ranks of an sp group hold the same rows; the batch group splits
    # the batch of 4
    rows = {}
    for r in ranks:
        d, f, _, e = r["steps"][case]["coordinate"]
        rows.setdefault((d, f, e), set()).add(tuple(r["steps"][case]["rows"]))
    assert all(len(v) == 1 for v in rows.values())
    assert sorted(i for v in rows.values() for i in next(iter(v))) == [
        0, 1, 2, 3]


DETECTS = ["dyyolo", "dyyolo_one_frame", "stem", "baseline", "dual",
           "dysoem", "dysoem_bf16", "data2_sp2", "data2_sp2_one_frame"]


@pytest.mark.parametrize("name", DETECTS)
def test_spatial_detect_gathers_one_process(setup, name):
    want = setup[1]["detect"][name]
    for rank in _ranks(setup, name):
        boxes, scores, valid = rank["detect"][name]
        assert boxes.shape == want[0].shape
        np.testing.assert_array_equal(valid, want[2])
        np.testing.assert_allclose(boxes, want[0], rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(scores, want[1], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", DETECTS)
def test_spatial_detect_runs_on_bands(setup, name):
    """Every rank with rows exchanged halos; the stem's kernels (A, B) ran
    once and kernel D three times per request on each rank's band."""
    want = {"stem": {"stem_l1": 1, "stem_l2": 1},
            "dysoem_bf16": {"dyconv": 3}}.get(name, {})
    for rank in _ranks(setup, name):
        calls = rank["detect"][name + " calls"]
        if name == "data2_sp2_one_frame" and not calls:
            continue   # the sp group without rows
        assert calls.get("halo", 0) > 0
        for k in ("stem_l1", "stem_l2", "dyconv"):
            assert calls.get(k, 0) == want.get(k, 0), (k, calls)


def test_data2_sp2_one_frame_has_a_group_without_rows(setup):
    counts = [r["detect"]["data2_sp2_one_frame calls"] for r in setup[3]]
    assert sum(1 for c in counts if not c) == 2


@pytest.mark.parametrize("conv", ["3x3 s1", "3x3 s2", "1x1 s2"])
def test_conv_rows_matches_the_whole_image(setup, conv):
    """Forward exact, backward to float64 rounding, on the band at each
    edge of the image (rank 0 the top, rank 1 the bottom) and across the
    boundary between them."""
    for rank in setup[2]:
        got = rank["halo"][conv]
        assert got["forward"] == 0.0
        assert got["input_grad"] < 1e-12 and got["weight_grad"] < 1e-12
        assert got["rows"] == (8 if conv == "3x3 s1" else 4)


def test_halo_of_uint8_frames(setup):
    assert all(r["halo"]["uint8 halo"]["equal"] for r in setup[2])


def test_sp_trainer_equals_one_process(setup):
    want = setup[1]["trainer"]
    for rank in setup[2]:
        got = rank["trainers"]["sp2"]
        assert got["mesh"] == {"data": 1, "fsdp": 1, "sp": 2, "ep": 1}
        assert got["step"] == 2
        for k in ("val_loss", "train_loss"):
            np.testing.assert_allclose(got["final"][k], want[k], rtol=1e-5)
        assert got["final"]["val_AP"] == pytest.approx(want["val_AP"],
                                                       abs=1e-6)


def test_row_band_rules():
    assert [list(row_band(i, 2, 8)) for i in range(2)] == [[0, 1, 2, 3],
                                                          [4, 5, 6, 7]]
    assert row_band(3, 4, 64, 16) == range(48, 64)
    with pytest.raises(ValueError, match="multiple of sp"):
        row_band(0, 4, 64, 32)
    assert model_stride(DyYOLO(CFG)) == 16
    assert model_stride(DyYOLO(STEM_CFG)) == 32
    assert model_stride(DySOEM_SimFPN()) == 8
    check_layout_supported(sp=4)


def test_trainer_refuses_devices_the_axes_do_not_divide(tmp_path):
    """``devices`` must be divisible by fsdp x sp x ep, as in the JAX
    trainer (checked before any process group is looked for)."""
    cfg = _trainer_config(tmp_path, devices=3, sp_devices=2)
    with pytest.raises(ValueError, match="not divisible by "
                       "fsdp_devices\\*sp_devices\\*ep_devices=2"):
        Trainer(Config(cfg), ListPipe([]), ListPipe([]),
                metrics=MetricsWriter(str(tmp_path / "dv")), device="cpu")


def test_spatial_detect_needs_an_sp_mesh():
    model = DyYOLO(CFG).eval()
    with pytest.raises(ValueError, match="requires mesh"):
        make_detector(model, HP, SIZE, spatial=True)

    class TwoAxes:
        mesh_dim_names = ("data", "fsdp")

    with pytest.raises(ValueError, match="'sp' mesh axis"):
        make_detector(model, HP, SIZE, mesh=TwoAxes(), spatial=True)
    with pytest.raises(ValueError, match="no spatial"):
        make_rtm_detector(None, SIZE, (16, 8), spatial=True)
