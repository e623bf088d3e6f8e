"""The port's multi-device training and sharded detect
(``uavdet_tpu_torch/parallel/``) on the CPU: two and four gloo processes
against one process on the global batch, and against the JAX package's
``make_sharded_train_step`` on its 8-device data mesh.

One two-rank process group (``parallel.dryrun.launch``) runs every check of
the module (``tests/torch_dist_worker.py:two_rank_job``) and one four-rank
group the HSDP case; each test then holds a part of the ranks' results
against what this process computes on the global batch. The tiny DyYOLO at
64 px, SGD with momentum, from the same seeded weights:

* DDP and FSDP2 (and, in the four-rank group, data 2 x fsdp 2) equal one
  process: losses rtol 1e-5, the gradients of every update within 1e-4 of
  each tensor's largest, the BatchNorm running mean and the biased running
  variance rtol 1e-5; so do a batch of 7 over two ranks (4 + 3), a batch
  of 1 (one rank without rows), and ``grad_batches`` 2 under DDP's
  ``no_sync`` and FSDP2's ``set_requires_gradient_sync(False)``; FSDP2 also
  with clipping by the global norm. These cases run in float64 (measured
  4.5e-14 of the largest gradient apart). In float32 the gradients of this
  run are not a fixed point to hold: a LeakyReLU input within rounding of 0
  takes the other slope, and on one batch of 8 the one-process float32
  step, the two-rank float32 step and the float64 step were 0.65 % to
  0.75 % of the largest gradient apart, pairwise, in a few BatchNorm
  biases (where on another batch they agree to 3.5e-6). So the float32
  DDP and FSDP2 steps are held to the one-process float32 step in their
  losses and BatchNorm running statistics (rtol 1e-5).
* A two-rank FSDP2 (and DDP) checkpoint restores bitwise in one process,
  and a one-process checkpoint restores bitwise on two FSDP2 (and DDP)
  ranks.
* The DDP step against the JAX sharded step at
  ``tests/test_parallel.py::test_dp_matches_single_device``'s shapes:
  the loss at the single-device tests' rtol 1e-4
  (tests/test_torch_train_step.py), the parameters after the update at
  rtol 1e-4 and atol 1e-5 (measured: 2 of 1152 elements of one kernel
  1.5e-6 apart, over an atol of 1e-6; the JAX test's own are rtol 5e-2,
  atol 5e-3).
* The sharded detect (5 frames over two ranks, 3 + 2, the dual-stream
  detector, one frame over two ranks with fewer NMS candidates than
  ``max_det``, and an RTMUAVDet with ``pre_nms_topk`` below ``max_det``
  over 5 frames and one) gathers the one-process detections.
* ``dryrun_multichip(2)`` runs.
"""

import os
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax

from tests.test_models import TINY_DY_CONFIG
from tests.test_torch_train_step import one_torch_thread  # noqa: F401
from tests.test_train_step import HP as JAX_HP
from tests.test_train_step import _synthetic_batch
from tests.torch_dist_worker import RTM_SCALES, rtm_model, run_steps
from uavdet_tpu.models import DyYOLO as JaxDyYOLO
from uavdet_tpu.parallel import make_mesh as jax_make_mesh
from uavdet_tpu.parallel import make_sharded_train_step, shard_batch
from uavdet_tpu.parallel.mesh import state_shardings
from uavdet_tpu.training import build_optimizer as jax_build_optimizer
from uavdet_tpu.training import init_state as jax_init_state
from uavdet_tpu_torch.inference import make_detector, make_rtm_detector
from uavdet_tpu_torch.models import DyYOLO
from uavdet_tpu_torch.models.rtm_uav_det import RTM_ANCHORS, RTMUAVDet
from uavdet_tpu_torch.parallel import (batch_group_size, check_batch_divisible,
                                       check_layout_supported, row_block)
from uavdet_tpu_torch.parallel.dryrun import dryrun_multichip, launch
from uavdet_tpu_torch.training import (CheckpointManager, build_optimizer,
                                       init_state)
from uavdet_tpu_torch.utils.seeding import init_weights
from uavdet_tpu_torch.utils.weights import state_dict_from_flax

SIZE = 64
CFG = tuple(tuple(t) for t in TINY_DY_CONFIG)
F32, F64 = torch.float32, torch.float64
HP = SimpleNamespace(
    anchors=(((40, 30), (60, 46), (54, 36)), ((18, 14), (24, 18), (30, 12)),
             ((6, 5), (10, 6), (13, 8))),
    lr=0.01, lr_scheduler=False, bbox_loss_fn="mse",
    loss_balancing=SimpleNamespace(obj_scales_w=(0.5, 1.0, 2.0), bbox_w=4.0,
                                   objectness_w=1.0, no_obj_w=4.0),
    optim=SimpleNamespace(name="SGD", momentum=0.78), attn_temperature=30.0,
    layer_config=CFG)


def noise_batches(rng, n, batch, size=SIZE, boxes=2):
    """n global batches of uniform noise frames with random boxes (numpy
    image, normalized xyxy boxes, mask)."""
    out = []
    for _ in range(n):
        imgs = rng.uniform(size=(batch, size, size, 3)).astype(np.float32)
        wh = rng.uniform(size / 8, size * 0.45, size=(batch, boxes, 2))
        cxy = rng.uniform(wh / 2 + 1, size - wh / 2 - 1)
        xyxy = (np.concatenate([cxy - wh / 2, cxy + wh / 2], -1)
                / size).astype(np.float32)
        out.append((imgs, xyxy, np.ones((batch, boxes), bool)))
    return out


def _model(state_dict, dtype=F32):
    m = DyYOLO(CFG, attn_temperature=30.0)
    m.load_state_dict(state_dict)
    return m.to(dtype)


# (name, fsdp, batches, grad_batches, grad_clip_val, dtype)
def _cases(rng):
    b8, b7, b1 = (noise_batches(rng, 2, 8), noise_batches(rng, 2, 7),
                  noise_batches(rng, 1, 1))
    return [("ddp", 1, b8, 1, None, F64), ("fsdp", 2, b8, 1, 1.0, F64),
            ("short", 1, b7, 1, None, F64), ("accum", 1, b8, 2, None, F64),
            ("fsdp_accum", 2, b8, 2, None, F64),
            ("zero", 1, b1, 1, None, F64),
            ("ddp32", 1, b8[:1], 1, None, F32),
            ("fsdp32", 2, b8[:1], 1, None, F32)]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """-> (the inputs of the two-rank job, this process's references, the
    two ranks' results, the four ranks' results). The process groups run
    while this process compiles the JAX sharded step."""
    tmp = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(5)
    sd = {k: v.clone() for k, v in
          init_weights(DyYOLO(CFG, attn_temperature=30.0), 3)
          .state_dict().items()}
    cases = _cases(rng)
    refs = {}
    for name, _, batches, gb, clip, dtype in cases:
        losses, grads, final, state = run_steps(
            _model(sd), HP, SIZE, batches, gb, None, clip, dtype)
        refs[name] = {"losses": losses, "grads": grads, "final": final}
        if name == "fsdp":   # the one-process checkpoint the ranks restore
            CheckpointManager(str(tmp / "ck" / "one")).save(
                state, 0, {"val_loss": 1.0})
            refs["one_saved"] = (final, state.step)

    jm = JaxDyYOLO(layer_config=TINY_DY_CONFIG)
    tx = jax_build_optimizer(JAX_HP)
    jbatch = _synthetic_batch(np.random.default_rng(211), batch=8)
    st = jax_init_state(jm, tx, jax.random.key(0), SIZE, batch_size=8)
    jsd = {k: torch.from_numpy(np.array(v)) for k, v in state_dict_from_flax(
        {"params": st.params, "batch_stats": st.batch_stats}, CFG).items()}
    frames = (rng.uniform(size=(5, SIZE, SIZE, 3)) * 255).astype(np.uint8)
    torch.manual_seed(4)
    rtm_sd = RTMUAVDet(RTM_ANCHORS, det_scales=RTM_SCALES).state_dict()
    dual = ((rng.uniform(size=(2, 96, 128, 3)) * 255).astype(np.uint8),
            (rng.uniform(size=(2, 64, 80, 3)) * 255).astype(np.uint8))
    spec = dict(state_dict=sd, hp=HP, size=SIZE, cases=cases,
                ckpt_dir=str(tmp / "ck"), jax_hp=SimpleNamespace(
                    **dict(vars(HP), lr=float(JAX_HP.lr))),
                jax_state_dict=jsd, jax_batch=tuple(
                    np.asarray(a) for a in jbatch),
                frames=frames, dual=dual, rtm_state_dict=rtm_sd)
    hsdp = [("hsdp", 2, *next(c for c in cases if c[0] == "ddp")[2:])]
    with ThreadPoolExecutor(2) as ex:
        two = ex.submit(launch, "tests.torch_dist_worker:two_rank_job", 2,
                        args=(spec,), timeout=240)
        four = ex.submit(launch, "tests.torch_dist_worker:step_cases", 4,
                         args=(sd, HP, SIZE, hsdp, ""), timeout=240)

        # the JAX sharded step on its 8-device data mesh
        mesh = jax_make_mesh(n_data=8, n_fsdp=1)
        st = jax.tree.map(jax.device_put, st, state_shardings(st, mesh))
        _, compile_step = make_sharded_train_step(jm, tx, JAX_HP, SIZE, mesh)
        st, m = compile_step(st)(st, shard_batch(jbatch, mesh))
        refs["jax"] = {"loss": float(m["loss"]),
                       "final": state_dict_from_flax(
                           {"params": st.params,
                            "batch_stats": st.batch_stats}, CFG)}
        det_model = _model(sd).eval()
        kw = dict(compute_dtype=F32, pre_nms_topk=64, max_det=16)
        refs["detect"] = {
            "single": [t.numpy() for t in make_detector(
                det_model, HP, SIZE, **kw)(frames)],
            "dual": [t.numpy() for t in make_detector(
                det_model, HP, SIZE, dual=True, **kw)(*dual)],
            "single_one_frame": [t.numpy() for t in make_detector(
                det_model, HP, SIZE, **dict(kw, pre_nms_topk=8))(
                    frames[:1])]}
        rtm = make_rtm_detector(rtm_model(rtm_sd), SIZE, RTM_SCALES,
                                pre_nms_topk=8, max_det=16)
        refs["detect"]["rtm"] = [t.numpy() for t in rtm(frames)]
        refs["detect"]["rtm_one_frame"] = [t.numpy() for t in rtm(
            frames[:1])]
        return spec, refs, two.result(), four.result()


@pytest.fixture(scope="module")
def two(setup):
    return setup[2]


def _bn(final):
    return {k: v for k, v in final.items()
            if k.endswith(("running_mean", "running_var"))}


def _assert_case(got, ref, scale_by_model=False):
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    assert len(got["grads"]) == len(ref["grads"]) > 0
    for g, r in zip(got["grads"], ref["grads"]):
        top = max(np.abs(v).max() for v in r.values())
        for k, v in r.items():
            atol = 1e-4 * (top if scale_by_model else np.abs(v).max())
            np.testing.assert_allclose(g[k], v, rtol=0, atol=atol,
                                       err_msg=k)
    for k, v in _bn(ref["final"]).items():
        np.testing.assert_allclose(got["final"][k], v, rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    for k, v in ref["final"].items():
        np.testing.assert_allclose(got["final"][k], v, rtol=1e-5, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("case", ["ddp", "fsdp", "short", "accum",
                                  "fsdp_accum", "zero"])
def test_step_equals_one_process(two, setup, case):
    """DDP / FSDP2 on two ranks equal one process on the global batch, in
    float64 (see the module docstring); both ranks end bitwise equal."""
    refs = setup[1]
    for rank in two:
        _assert_case(rank["steps"][case], refs[case])
    a, b = (r["steps"][case]["final"] for r in two)
    assert all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("case", ["ddp32", "fsdp32"])
def test_float32_step_equals_one_process(two, setup, case):
    """In float32: the losses and the BatchNorm running statistics of one
    microbatch (see the module docstring for the gradients)."""
    refs = setup[1]
    got, ref = two[0]["steps"][case], refs[case]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    for k, v in _bn(ref["final"]).items():
        np.testing.assert_allclose(got["final"][k], v, rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def test_fsdp_takes_channels_last_parameters(two, setup):
    """The card's models hold channels_last conv weights, which FSDP2
    refuses: ``shard_model`` makes them contiguous, and the step is the
    same."""
    want = setup[1]["fsdp"]["final"]
    got = two[0]["fsdp_channels_last"]
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-10, atol=1e-12,
                                   err_msg=k)


def test_fsdp_checkpoint_restores_in_one_process(two, setup):
    spec, refs = setup[:2]
    saved = two[0]["steps"]["fsdp_saved"]
    model = _model(spec["state_dict"], F64)
    state = init_state(model, *build_optimizer(model.parameters(), HP))
    CheckpointManager(os.path.join(spec["ckpt_dir"], "two")).restore(state)
    sd = model.state_dict()
    for k, v in saved.items():
        assert np.array_equal(sd[k].numpy(), v), k
    assert state.step == 2 and state.mini_step == 0
    assert state.scheduler.last_epoch == 2
    assert len(state.optimizer.state) == len(list(model.parameters()))


def test_ddp_checkpoint_round_trip(two, setup):
    """A two-rank DDP checkpoint restores bitwise in one process, and the
    one-process checkpoint bitwise on two DDP ranks (rank 0 loads and
    broadcasts)."""
    spec, refs = setup[:2]
    saved = two[0]["steps"]["ddp_saved"]
    model = _model(spec["state_dict"], F64)
    state = init_state(model, *build_optimizer(model.parameters(), HP))
    CheckpointManager(os.path.join(spec["ckpt_dir"], "two_ddp")).restore(
        state)
    sd = model.state_dict()
    for k, v in saved.items():
        assert np.array_equal(sd[k].numpy(), v), k
    assert state.step == 2 and len(state.optimizer.state) == len(
        list(model.parameters()))
    final, step = refs["one_saved"]
    for rank in two:
        got = rank["steps"]["ddp_restored"]
        for k, v in final.items():
            assert np.array_equal(got[k], v), k
        assert rank["steps"]["ddp_restored_step"] == (step, 0)


def test_one_process_checkpoint_restores_on_two_ranks(two, setup):
    refs = setup[1]
    final, step = refs["one_saved"]
    for rank in two:
        got = rank["steps"]["fsdp_restored"]
        for k, v in final.items():
            assert np.array_equal(got[k], v), k
        assert rank["steps"]["fsdp_restored_step"] == (step, 0)


def test_ddp_step_against_jax_sharded_step(two, setup):
    """The port's DDP step on two ranks against the JAX step on an 8-device
    data mesh, from the same flax init and batch."""
    refs = setup[1]
    got = two[0]["jax_case"]
    np.testing.assert_allclose(got["losses"][0, 0], refs["jax"]["loss"],
                               rtol=1e-4)
    for k, v in refs["jax"]["final"].items():
        if k.endswith("num_batches_tracked"):   # flax keeps no count
            continue
        np.testing.assert_allclose(got["final"][k], np.asarray(v),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("which", ["single", "dual", "single_one_frame",
                                   "rtm", "rtm_one_frame"])
def test_sharded_detect_gathers_one_process(two, setup, which):
    """DyYOLO (one frame: rank 1 holds no rows, and 8 candidates fill 8 of
    the 16 slots) and RTMUAVDet (``pre_nms_topk`` 8 below ``max_det`` 16):
    the gathered detections are the one-process detect's, shape
    included."""
    refs = setup[1]
    want = refs["detect"][which]
    for rank in two:
        boxes, scores, valid = rank["detect"][which]
        assert boxes.shape == want[0].shape
        np.testing.assert_array_equal(valid, want[2])
        np.testing.assert_allclose(boxes, want[0], rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(scores, want[1], rtol=1e-5, atol=1e-7)


def test_hsdp_four_ranks_equals_one_process(setup):
    """data 2 x fsdp 2 on four processes: the same as one process."""
    refs = setup[1]
    for rank in setup[3]:
        _assert_case(rank["hsdp"], refs["ddp"])


def test_dryrun_multichip_two():
    out = dryrun_multichip(2)
    assert out["mesh"] == {"data": 1, "fsdp": 2}
    assert np.isfinite(out["loss"]) and out["local_rows"] == [2, 2]
    assert out["detections"] == [4, 16, 4] and out["step"] == 1
    assert out["sp_ep"]["mesh"] == {"data": 1, "sp": 2, "ep": 1}
    assert np.isfinite(out["sp_ep"]["loss"])
    # mesh 3: two pp stages in each rank's process, the ranks agreeing
    assert np.isfinite(out["pp_loss"])
    assert out["pp"]["stages"] == out["pp"]["microbatches"] == 2
    assert out["pp"]["rows"] == 4 and len(out["pp"]["ranges"]) == 2


def test_layout_checks():
    """``sp``, ``ep`` and ``pp`` are taken (tests/test_torch_spatial.py,
    tests/test_torch_experts.py, tests/test_torch_pipeline.py); a size
    below 1 raises."""
    check_layout_supported(sp=2)
    check_layout_supported(ep=2)
    check_layout_supported(sp=2, ep=2)
    assert check_layout_supported(pp=2) is None
    with pytest.raises(ValueError, match="at least 1"):
        check_layout_supported(pp=-1)
    check_layout_supported(1, 1, 1)
    assert [list(row_block(i, 2, 7)) for i in range(2)] == [[0, 1, 2, 3],
                                                           [4, 5, 6]]
    assert [len(row_block(i, 4, 5)) for i in range(4)] == [2, 2, 1, 0]
    assert [list(row_block(i, 4, 8)) for i in range(4)] == [
        [0, 1], [2, 3], [4, 5], [6, 7]]

    class Sub:
        def __init__(self, n):
            self.n = n

        def size(self):
            return self.n

    class Mesh(dict):
        pass

    mesh = Mesh(data=Sub(2), fsdp=Sub(2), sp=Sub(1), ep=Sub(1))
    assert batch_group_size(mesh) == 4
    check_batch_divisible(8, mesh)
    with pytest.raises(ValueError, match="divisible"):
        check_batch_divisible(6, mesh)
    # the batch shards over data x fsdp x ep; the sp ranks share rows
    mesh = Mesh(data=Sub(2), fsdp=Sub(1), sp=Sub(2), ep=Sub(2))
    assert batch_group_size(mesh) == 4
    check_batch_divisible(4, mesh)
    with pytest.raises(ValueError, match="data\\*fsdp\\*ep"):
        check_batch_divisible(6, mesh)
