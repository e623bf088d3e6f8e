"""A reference Lightning checkpoint through the port: ``python -m
uavdet_tpu_torch.scripts.port_reference_checkpoint`` then ``python -m
uavdet_tpu_torch.evaluate --ckpt last --dump``, on the CPU.

The counterpart of tests/test_ckpt_port_e2e.py. The ``.ckpt`` is made from
the reference-structure model of tests/test_torch_import.py
(``TorchDyYOLO``, random BatchNorm statistics), as that file makes it. The
port's two commands run as subprocesses with ``--device cpu`` (float32);
the JAX chain runs in this process (``uavdet_tpu.utils.torch_import``'s
``load_lightning_checkpoint``, then its ``make_detector`` in float32) on the
same frames, the port's validation batches. Limits, the detector-parity
ones of tests/test_torch_detector.py: ``valid`` equal, scores rtol 1e-4,
boxes 1e-4, where two candidates whose scores tie to within that noise may
trade places.
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml
import jax.numpy as jnp

from tests.test_entry_points import _PP
from tests.test_torch_detector import _assert_same_detections
from tests.test_torch_entry_points import HPARAMS
from tests.test_torch_import import CFG, TorchDyYOLO
from tests.test_torch_train_step import one_torch_thread  # noqa: F401
from uavdet_tpu.inference import make_detector as jax_make_detector
from uavdet_tpu.models import build_model as jax_build_model
from uavdet_tpu.utils.config import Config as JaxConfig
from uavdet_tpu.utils.torch_import import \
    load_lightning_checkpoint as jax_load_lightning_checkpoint
from uavdet_tpu_torch import prepare_dataloader
from uavdet_tpu_torch.data import DataPipeline, load_manifest, \
    make_synthetic_dataset
from uavdet_tpu_torch.utils.config import Config
from uavdet_tpu_torch.utils.torch_import import (
    import_interpreter_state_dict, load_lightning_checkpoint)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64
CKPT = "best-01-2.4163.ckpt"


def _reference_state_dict():
    torch.manual_seed(7)
    tm = TorchDyYOLO(CFG).eval()
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.05)
                m.running_var.uniform_(0.8, 1.2)
    return tm.state_dict()


def _run(module, wd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + _PP)
    return subprocess.run(
        [sys.executable, "-m", f"uavdet_tpu_torch.{module}", *args],
        cwd=wd, env=env, capture_output=True, text=True, timeout=300)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A synthetic tree with its manifests, a params.yaml of the CFG model,
    and a Lightning-format checkpoint of the reference-structure model."""
    wd = tmp_path_factory.mktemp("torch_ckpt_import")
    make_synthetic_dataset(str(wd / "data" / "Anti-UAV-RGBT"), n_seq=1,
                           n_frames=6, img_size=128, device="cpu")
    params = {
        "dataset": {
            "root_dir": "data/Anti-UAV-RGBT",
            "train_loader_path": "data/train_manifest.json",
            "val_loader_path": "data/val_manifest.json",
            "test_loader_path": "data/test_manifest.json",
            "batch_size": 2, "remote": False, "image_size": [SIZE, SIZE],
            "workers": 1, "mosaic": False, "format": "yolo"},
        "train": {"seed": 211,
                  "checkpoint": {"dir": "logs/checkpoints",
                                 "monitor": "val_loss", "mode": "min"}},
        "model": {"name": "DyYOLO",
                  "hparams": dict(HPARAMS,
                                  layer_config=[list(t) for t in CFG])}}
    with open(wd / "params.yaml", "w") as f:
        yaml.safe_dump(params, f)
    here = os.getcwd()
    os.chdir(wd)
    try:
        prepare_dataloader.main(Config(params))
    finally:
        os.chdir(here)
    torch.save({"state_dict": _reference_state_dict(), "epoch": 1,
                "global_step": 72573, "pytorch-lightning_version": "2.4.0"},
               wd / CKPT)
    return wd, params


def test_port_then_evaluate_matches_the_jax_importers_detector(
        workdir, one_torch_thread):
    wd, params = workdir
    r = _run("scripts.port_reference_checkpoint", wd, CKPT,
             "logs/checkpoints")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "ported" in r.stdout
    r = _run("evaluate", wd, "--split", "val", "--ckpt", "last", "--batch",
             "2", "--device", "cpu", "--dump", "dets.json")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Restored checkpoint 'last'" in r.stdout
    out = json.loads(r.stdout.strip().splitlines()[-1])
    dets = json.loads((wd / "dets.json").read_text())["images"]
    assert out["images"] == len(dets) > 0

    # the JAX chain in this process, on the port's validation batches
    cfg = JaxConfig(params)
    hp = cfg.model.hparams
    p, s = jax_load_lightning_checkpoint(str(wd / CKPT), CFG)
    detect = jax_make_detector(jax_build_model("DyYOLO", hp,
                                               dtype=jnp.float32),
                               hp, SIZE, compute_dtype=jnp.float32)
    records = load_manifest(str(wd / "data" / "val_manifest.json"))
    for rec in records:   # manifest paths are relative to the workdir
        rec["img_path"] = str(wd / rec["img_path"])
    pipe = DataPipeline(records, input_size=SIZE, batch_size=2, train=False,
                        shuffle=False, drop_last=False, device="cpu")
    i = 0
    for batch in pipe:
        want = detect({"params": p, "batch_stats": s},
                      jnp.asarray(batch.image.numpy()))
        b, k = want.valid.shape
        rows = dets[i:i + b]
        n = np.array([len(d["scores"]) for d in rows])
        boxes = np.zeros((b, k, 4), np.float32)
        scores = np.zeros((b, k), np.float32)
        for j, d in enumerate(rows):
            scores[j, :n[j]] = d["scores"]
            boxes[j, :n[j]] = np.reshape(d["boxes_xyxy"], (-1, 4))
        got = SimpleNamespace(boxes=torch.from_numpy(boxes),
                              scores=torch.from_numpy(scores),
                              valid=torch.from_numpy(np.arange(k) < n[:, None]))
        _assert_same_detections(got, want)
        i += b
    assert i == len(dets)


def test_missing_key_raises_and_names_it(tmp_path):
    sd = _reference_state_dict()
    del sd["layers.3.conv.weight"]
    sd["layers.99.conv.weight"] = torch.zeros(1)
    torch.save({"state_dict": sd}, tmp_path / "broken.ckpt")
    with pytest.raises(ValueError, match=r"missing \(1\): "
                       r"\['layers.3.conv.weight'\].*unexpected \(1\): "
                       r"\['layers.99.conv.weight'\]"):
        load_lightning_checkpoint(str(tmp_path / "broken.ckpt"), CFG)


def test_shape_mismatch_raises_and_names_it():
    sd = _reference_state_dict()
    sd["layers.1.conv.weight"] = sd["layers.1.conv.weight"][:, :4]
    with pytest.raises(ValueError, match=r"shape \(1\): "
                       r"\['layers.1.conv.weight \(16, 4, 3, 3\) != "
                       r"\(16, 8, 3, 3\)'\]"):
        import_interpreter_state_dict(sd, CFG)


def test_bare_state_dict_of_arrays_loads():
    """A checkpoint that is a bare state_dict of numpy arrays imports as
    one of tensors, equal value for value."""
    sd = _reference_state_dict()
    got = import_interpreter_state_dict({k: v.numpy() for k, v in sd.items()},
                                        CFG)
    assert set(got) == set(sd)
    assert all(torch.equal(got[k], sd[k]) for k in sd)
