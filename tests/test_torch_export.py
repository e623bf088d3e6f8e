"""The port's kernels as registered operators, and its export
(``uavdet_tpu_torch/export.py``, ``scripts/export_detector.py``), on the CPU.

``torch.library.opcheck`` holds each registered operator (kernels A, B, C,
D, E and G) at the kernels' edge shapes: its schema, its fake (shape-only)
implementation against the real one, and its dispatch. On the CPU the
operators run the kernels' plain versions.

An artifact of ``export_detector`` runs the same operations in the same
order as the live detector, so its detections are expected bitwise equal
to it; they are held to rtol 1e-5, atol 1e-5. Against the JAX package's
artifact from the same weights (its Pallas stem in interpret mode, as
tests/test_torch_detector.py runs it) the limits are the detector-parity
ones of that file: ``valid`` equal, scores rtol 1e-4, boxes 1e-4.
"""

import io
import os
import subprocess
import sys
import zipfile
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tests.test_torch_baseline import TINY_BASE
from tests.test_torch_detector import TinyHP, _assert_same_detections
from tests.test_torch_entry_points import HPARAMS
from tests.test_torch_model import TINY_CFG, models_for
from tests.test_torch_train_step import one_torch_thread  # noqa: F401
from uavdet_tpu.export import export_detector as jax_export_detector
from uavdet_tpu.export import load_detector as jax_load_detector
from uavdet_tpu_torch.evaluate import restored_model
from uavdet_tpu_torch.export import export_detector, load_detector
from uavdet_tpu_torch.inference import make_detector
from uavdet_tpu_torch.models import (DYSOEM, BaselineModel, DySOEM_SimFPN,
                                     DyYOLO)
from uavdet_tpu_torch.ops.block import (BLOCK_EDGE_SHAPES,
                                        pack_block_weights)
from uavdet_tpu_torch.ops.dyconv import EDGE_SHAPES
from uavdet_tpu_torch.ops.nms import NMS_EDGE_CASES, nms_edge_case
from uavdet_tpu_torch.ops.stem import L1_EDGE_SHAPES, L2_EDGE_SHAPES
from uavdet_tpu_torch.scripts import export_detector as export_cli
from uavdet_tpu_torch.training import (CheckpointManager, build_optimizer,
                                       init_state)
from uavdet_tpu_torch.utils.config import Config
from uavdet_tpu_torch.utils.seeding import init_weights, seeded_model
from uavdet_tpu_torch.utils.weights import load_flax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64
# the TINY tail behind the stem that kernels A and B implement
STEM_TINY = (("DyConv", 32, 3, 1), ("DyConv", 64, 3, 2)) + TINY_CFG[1:]
BF16 = torch.bfloat16


def _t(rng, shape, dtype=torch.float32, scale=1.0):
    return torch.from_numpy(
        (rng.normal(size=shape) * scale).astype(np.float32)).to(dtype)


def _frames(rng, batch, h=SIZE, w=SIZE):
    return rng.integers(0, 256, (batch, h, w, 3), dtype=np.uint8)


def _opcheck(op, args):
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


# ------------------------------------------------------------- the operators

@pytest.mark.parametrize("shape", L1_EDGE_SHAPES)
@pytest.mark.parametrize("u8", [True, False])
def test_stem_l1_op(rng, shape, u8):
    b, h, w = shape
    x = (torch.from_numpy(rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8))
         if u8 else _t(rng, (b, h, w, 3), BF16))
    _opcheck(torch.ops.uavdet.stem_l1.default, (x, _t(rng, (b, 32, 28),
                                                      scale=0.1)))


@pytest.mark.parametrize("shape", L2_EDGE_SHAPES)
def test_stem_l2_op(rng, shape):
    b, h, w = shape
    _opcheck(torch.ops.uavdet.stem_l2.default,
             (_t(rng, (b, h, w, 32), BF16), _t(rng, (b, 64, 289), scale=0.1)))


@pytest.mark.parametrize("shape", L1_EDGE_SHAPES)
def test_stem_fused_op(rng, shape):
    b, h, w = shape
    x = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8))
    _opcheck(torch.ops.uavdet.stem_fused.default,
             (x, _t(rng, (b, 32, 28), scale=0.01),
              _t(rng, (b, 64, 289), scale=0.1)))


@pytest.mark.parametrize("case", [c for c in NMS_EDGE_CASES if c[2] <= 200])
def test_nms_alive_op(rng, case):
    boxes, _ = nms_edge_case(*case, rng)
    _opcheck(torch.ops.uavdet.nms_alive.default,
             (torch.from_numpy(boxes), 0.5))


@pytest.mark.parametrize("shape", EDGE_SHAPES)
@pytest.mark.parametrize("fold_out,emit_gap", [(False, False), (False, True),
                                               (True, True)])
def test_dyconv_op(rng, shape, fold_out, emit_gap):
    b, h, w, c, co = shape
    if fold_out and h % 2:
        h += 1
    args = (_t(rng, (b, h, w, c), BF16), _t(rng, (b, 9, c, co), BF16, 0.1),
            _t(rng, (co,)), _t(rng, (b, co)), fold_out, emit_gap)
    _opcheck(torch.ops.uavdet.dyconv.default, args)


@pytest.mark.parametrize("shape", [s for s in BLOCK_EDGE_SHAPES
                                   if s[1] * s[2] <= 400])
@pytest.mark.parametrize("packed", [True, False])
def test_post_stem_block_op(rng, shape, packed):
    ws = [_t(rng, s, scale=0.05) for s in ((32, 65), (64, 289), (128, 577))]
    ps = pack_block_weights(*ws)
    none = [None] * 3
    _opcheck(torch.ops.uavdet.post_stem_block.default,
             (_t(rng, (*shape, 64), BF16), *ws,
              [p.image for p in ps] if packed else none,
              [p.bias for p in ps] if packed else none))


# ------------------------------------------------------------ the artifacts

def _program(blob):
    return torch.export.load(io.BytesIO(blob))


def _ops(program):
    """Calls of the registered operators in the program's graph."""
    return sorted(str(n.target) for n in program.graph.nodes
                  if str(n.target).startswith("uavdet."))


def _named(triple):
    return SimpleNamespace(**dict(zip(("boxes", "scores", "valid"), triple)))


def _assert_equal_detections(got, want):
    gb, gs, gv = got
    assert torch.equal(gv, want.valid)
    torch.testing.assert_close(gb, want.boxes, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(gs, want.scores, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def stem_models():
    """(flax model, its variables, the port's model) with the same weights:
    the port's seeded weights taken to flax by the JAX package's import and
    back to the port through ``utils/weights.py``."""
    jm, v, _ = models_for(STEM_TINY, 41)
    port = DyYOLO(STEM_TINY, attn_temperature=30.0).eval()
    load_flax_variables(port, v)
    return jm, v, port


@pytest.fixture(scope="module")
def dyyolo_blob(stem_models):
    return export_detector(stem_models[2], TinyHP, SIZE, 2,
                           compute_dtype=torch.float32)


def test_dyyolo_artifact(rng, stem_models, dyyolo_blob, one_torch_thread):
    """The artifact gives the live detector's detections and the JAX
    package's artifact's from the same weights; the frames are its only
    input (the decode tables are constants) and it keeps no example frames,
    and it calls kernels A, B and C once each."""
    jm, v, port = stem_models
    archive = zipfile.ZipFile(io.BytesIO(dyyolo_blob)).infolist()
    assert sum(i.file_size for i in archive
               if "sample_inputs" in i.filename) == 0   # no zero frames
    program = _program(dyyolo_blob)
    kinds = [s.kind.name for s in program.graph_signature.input_specs]
    assert kinds.count("USER_INPUT") == 1 and "CONSTANT_TENSOR" in kinds
    assert _ops(program) == ["uavdet.nms_alive.default",
                             "uavdet.stem_l1.default",
                             "uavdet.stem_l2.default"]
    x = _frames(rng, 2)
    got = load_detector(dyyolo_blob)(x)
    live = make_detector(port, TinyHP, SIZE, compute_dtype=torch.float32)
    _assert_equal_detections(got, live(x))

    jdet = jax_load_detector(jax_export_detector(
        jm, TinyHP, v, SIZE, 2, compute_dtype=jnp.float32,
        pallas_stem_interpret=True, fold_early=False))
    _assert_same_detections(_named(got), _named(jdet(x)))


def test_dual_artifact(rng, stem_models, one_torch_thread):
    """RGB 1080x1920 + infrared 512x640 uint8 -> 2B detections, as the live
    dual-stream detector gives them."""
    port = stem_models[2]
    blob = export_detector(port, TinyHP, SIZE, 1, dual=True,
                           compute_dtype=torch.float32)
    rgb, ir = _frames(rng, 1, 1080, 1920), _frames(rng, 1, 512, 640)
    got = load_detector(blob)(rgb, ir)
    assert got[0].shape[0] == 2   # modality-major, RGB first
    live = make_detector(port, TinyHP, SIZE, compute_dtype=torch.float32,
                         dual=True)
    _assert_equal_detections(got, live(rgb, ir))


def test_dysoem_artifact(rng, one_torch_thread):
    """A bf16 DySOEM_SimFPN: its three SOEMs call kernel D's operator."""
    model = init_weights(DySOEM_SimFPN(), 5).to(BF16).eval()
    blob = export_detector(model, DYSOEM, SIZE, 2)
    assert _ops(_program(blob)) == ["uavdet.dyconv.default"] * 3 + [
        "uavdet.nms_alive.default"]
    x = _frames(rng, 2)
    _assert_equal_detections(load_detector(blob)(x),
                             make_detector(model, DYSOEM, SIZE)(x))


def test_baseline_artifact(rng, one_torch_thread):
    model = init_weights(BaselineModel(TINY_BASE), 6).eval()
    blob = export_detector(model, TinyHP, SIZE, 1,
                           compute_dtype=torch.float32)
    assert _ops(_program(blob)) == ["uavdet.nms_alive.default"]
    x = _frames(rng, 1)
    live = make_detector(model, TinyHP, SIZE, compute_dtype=torch.float32)
    _assert_equal_detections(load_detector(blob)(x), live(x))


def test_export_needs_eval_mode(stem_models):
    port = stem_models[2]
    port.train()
    try:
        with pytest.raises(ValueError, match="eval mode"):
            export_detector(port, TinyHP, SIZE, 1)
    finally:
        port.eval()


def test_load_in_a_fresh_process(rng, tmp_path, stem_models, dyyolo_blob):
    """A process that imports only ``uavdet_tpu_torch.export`` serves the
    artifact: no module under ``models/``, no JAX, no JAX package."""
    x = _frames(rng, 2)
    (tmp_path / "det.pt2").write_bytes(dyyolo_blob)
    np.save(tmp_path / "x.npy", x)
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from uavdet_tpu_torch.export import load_detector\n"
        "det = load_detector(open(sys.argv[1], 'rb').read())\n"
        "b, s, v = det(np.load(sys.argv[2]))\n"
        "bad = [m for m in sys.modules if m.startswith("
        "'uavdet_tpu_torch.models') or m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'uavdet_tpu')]\n"
        "assert not bad, bad\n"
        "np.savez(sys.argv[3], b=b.numpy(), s=s.numpy(), v=v.numpy())\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path / "det.pt2"),
                          str(tmp_path / "x.npy"), str(tmp_path / "out.npz")],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = np.load(tmp_path / "out.npz")
    live = make_detector(stem_models[2], TinyHP, SIZE,
                         compute_dtype=torch.float32)(x)
    _assert_equal_detections(tuple(torch.from_numpy(out[k])
                                   for k in "bsv"), live)


def test_export_cli_restores_the_checkpoint(rng, tmp_path, monkeypatch,
                                            one_torch_thread):
    """``scripts.export_detector --device cpu --ckpt last``: a bf16 artifact
    of the checkpoint's weights (here seed 5's, not the seed 0 the script
    starts from), equal to the detector ``evaluate`` restores."""
    monkeypatch.chdir(tmp_path)
    config = Config({
        "dataset": {"image_size": [SIZE, SIZE]},
        "train": {"checkpoint": {"dir": "ckpt", "monitor": "val_loss",
                                 "mode": "min"}},
        "model": {"name": "DyYOLO",
                  "hparams": dict(HPARAMS, layer_config=STEM_TINY)}})
    hp = config.model.hparams
    model = seeded_model("DyYOLO", hp, 5, "cpu", dtype=torch.float32)
    mgr = CheckpointManager("ckpt")
    mgr._save(init_state(model, *build_optimizer(model.parameters(), hp)),
              os.path.join(mgr.ckpt_dir, "last"))

    assert export_cli.main(config, ["--out", "det.pt2", "--ckpt", "last",
                                    "--device", "cpu", "--batch", "2"]) == 0
    x = _frames(rng, 2)
    got = load_detector((tmp_path / "det.pt2").read_bytes())(x)
    restored, name = restored_model(config, "last", torch.device("cpu"), BF16)
    assert name == "last"
    _assert_equal_detections(got, make_detector(restored, hp, SIZE)(x))
    _assert_equal_detections(got, make_detector(model.to(BF16), hp, SIZE)(x))
    assert export_cli.main(config, ["--out", "x.pt2", "--ckpt", "best",
                                    "--device", "cpu"]) == 1
