"""The port's multi-process start-up and sharded host decode
(``uavdet_tpu_torch/parallel/multihost.py``, ``DataPipeline.set_local_rows``)
and its Trainer on a mesh, on the CPU.

* ``set_local_rows``: on every rank's rows, membership and boxes equal the
  JAX package's ``_batches_sharded`` (its native loader off, as in
  tests/test_torch_data.py), for train and val, workers 1 and 2, mosaic on
  and off; the local rows' pixels stay within tests/test_torch_data.py's
  bounds of the JAX rows (max 1 and mean 0.2 units of 255); the pipeline
  reads and decodes the files of its rows alone (every other frame only
  through its header); a remote ``fs`` returns False and decodes
  everything.
* Two gloo processes (``parallel.dryrun.launch``): ``Trainer.fit`` with
  ``devices: 2`` and ``multihost: true`` over the pipelines, each rank
  reading only its rows' files, equal to one process (losses rtol 1e-3,
  the tolerance of the JAX package's own two-process test: the synthetic
  frames are flat, see tests/test_torch_train_trainer.py); ``Trainer`` with
  ``devices: 2`` (DDP) and with ``fsdp_devices: 2`` over fixed noise
  batches gives one process's validation loss and ``val_AP``.
* Two processes that no launcher started: the ``Trainer`` starts the
  group from ``coordinator`` (a TCP address on this host), ``num_processes``
  and ``process_id``, over gloo.
* ``dryrun_multichip(4)`` runs (data 2 x fsdp 2, then data 1 x sp 2 x ep
  2).
"""

import copy
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import uavdet_tpu.data.native as jax_native
from tests.test_torch_data import _assert_same_batches
from tests.test_torch_parallel import noise_batches
from tests.test_torch_train_step import one_torch_thread  # noqa: F401
from tests.test_torch_train_trainer import ListPipe, _config_dict
from uavdet_tpu.data import DataPipeline as JaxPipeline
from uavdet_tpu.data import build_index as jax_build_index
from uavdet_tpu.data import make_synthetic_dataset as jax_synthetic
from uavdet_tpu_torch.data import DataPipeline
from uavdet_tpu_torch.data import frames
from uavdet_tpu_torch.parallel import local_rows_of, shard_host_batch
from uavdet_tpu_torch.parallel.dryrun import dryrun_multichip, launch
from uavdet_tpu_torch.training import MetricsWriter, Trainer
from uavdet_tpu_torch.utils.config import Config
from uavdet_tpu_torch.utils.datatypes import BatchData

SIZE = 64
RANKS = ({0, 1}, {2, 3})   # two ranks' rows of a batch of 4


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return jax_synthetic(str(tmp_path_factory.mktemp("mh")), n_seq=2,
                         n_frames=8, img_size=96, seed=3)


@pytest.fixture(scope="module")
def records(root):
    return jax_build_index(os.path.join(root, "train"), seed=11)


@pytest.fixture
def cv2_path(monkeypatch):
    monkeypatch.setattr(jax_native, "get_lib", lambda: None)


def _port(records, rows=None, **kw):
    pipe = DataPipeline(records, device="cpu", **kw)
    if rows is not None:
        assert pipe.set_local_rows(rows)
    return pipe


@pytest.mark.parametrize("train,workers,mosaic",
                         [(True, 1, False), (True, 2, False),
                          (False, 1, False), (True, 1, True),
                          (True, 2, True)])
def test_local_rows_match_jax_sharded(cv2_path, records, train, workers,
                                      mosaic):
    kw = dict(input_size=SIZE, batch_size=4, train=train, seed=5,
              workers=workers, mosaic=mosaic)
    for rows in RANKS:
        jp = JaxPipeline(records, **kw)
        assert jp.set_local_rows(rows)
        jp.device_prefetch = False
        want = [BatchData(*(np.asarray(t)[sorted(rows)] for t in b))
                for b in jp._batches()]
        got = list(_port(records, rows, **kw))
        _assert_same_batches(want, got)


def test_local_rows_read_only_their_files(records, monkeypatch):
    """Each rank's full-file reads and decodes are the files of its rows,
    the two ranks' disjoint and together every kept sample's; the other
    frames are read through their headers alone."""
    reads, decodes, headers = [], [], []
    read, decode, size = (DataPipeline._read, frames.decode_cpu,
                          frames.image_size)
    monkeypatch.setattr(DataPipeline, "_read", lambda self, p: (
        reads.append(p), read(self, p))[1])
    monkeypatch.setattr(frames, "decode_cpu", lambda d: (
        decodes.append(1), decode(d))[1])
    monkeypatch.setattr(frames, "image_size", lambda p, dev: (
        headers.append(p), size(p, dev))[1])
    kw = dict(input_size=SIZE, batch_size=4, train=True, seed=5)
    batches = list(_port(records, range(4), **kw))
    kept = list(reads)
    assert len(kept) == 4 * len(batches) and len(batches) > 1
    per_rank = []
    for rows in RANKS:
        reads.clear()
        decodes.clear()
        headers.clear()
        got = list(_port(records, rows, **kw))
        assert [len(b.image) for b in got] == [2] * len(batches)
        want = [p for i, p in enumerate(kept) if i % 4 in rows]
        assert reads == want and len(decodes) == len(want)
        assert sorted(headers) == sorted(r["img_path"] for r in records)
        per_rank.append(set(reads))
    assert per_rank[0].isdisjoint(per_rank[1])
    assert per_rank[0] | per_rank[1] == set(kept)


def test_remote_fs_returns_false(records):
    pipe = DataPipeline(records, SIZE, 4, train=True, fs=object(),
                        device="cpu")
    assert not pipe.set_local_rows({0})
    assert pipe.local_rows is None
    assert DataPipeline(records, SIZE, 4, train=True, mosaic=True,
                        device="cpu").set_local_rows({0})


def test_short_batch_rows_and_slices():
    """A short last batch: a rank keeps its rows below the batch's length,
    possibly none."""
    b = BatchData(np.arange(7), np.arange(7) * 2, np.ones(7, bool))
    assert list(shard_host_batch(b, {4, 5, 6, 7}).image) == [4, 5, 6]
    assert len(shard_host_batch(BatchData(*(t[:3] for t in b)),
                                {4, 5, 6, 7}).image) == 0
    assert local_rows_of({6, 7}, 7) == [6]


def _trainer_config(tmp, **trainer):
    cfg = _config_dict(tmp, train_batches=2, val_batches=1, eval_ap=True,
                       **trainer)
    cfg["dataset"]["batch_size"] = 4
    return cfg


@pytest.fixture(scope="module")
def job(root, records, tmp_path_factory):
    """-> (the ranks' results, the one-process references, every kept
    training sample's path in batch-row order)."""
    tmp = tmp_path_factory.mktemp("mh_job")
    rng = np.random.default_rng(9)
    val_records = jax_build_index(os.path.join(root, "val"), seed=11)
    train = [BatchData(*b) for b in noise_batches(rng, 2, 4)]
    val = [BatchData(*b) for b in noise_batches(rng, 1, 4)]
    configs = {"ddp": _trainer_config(tmp / "t_ddp", devices=2),
               "fsdp": _trainer_config(tmp / "t_fsdp", devices=2,
                                       fsdp_devices=2)}
    spec = dict(train_records=records, val_records=val_records, size=SIZE,
                multihost_config=_trainer_config(tmp / "ck_mh", devices=2,
                                                 multihost=True),
                train=train, val=val, trainer_configs=configs,
                workdir=str(tmp))
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(launch, "tests.torch_dist_worker:multihost_job",
                          2, args=(spec,), timeout=240)
        refs = {"trainer": Trainer(
            Config(_trainer_config(tmp / "t_one")), ListPipe(train),
            ListPipe(val), metrics=MetricsWriter(str(tmp / "dv_one")),
            device="cpu").fit()}
        refs["multihost"] = Trainer(
            Config(_trainer_config(tmp / "ck_one")),
            DataPipeline(records, SIZE, 4, train=True, seed=1, device="cpu"),
            DataPipeline(val_records, SIZE, 4, train=False, seed=2,
                         device="cpu"),
            metrics=MetricsWriter(str(tmp / "dv_mh_one")),
            device="cpu").fit()
        order = []
        pipe = DataPipeline(records, SIZE, 4, train=True, seed=1,
                            device="cpu")
        pipe.set_local_rows(range(4))
        read = pipe._read
        pipe._read = lambda p: (order.append(p), read(p))[1]
        list(pipe)
        return ranks.result(), refs, order, tmp


def test_multihost_trainer_reads_only_its_rows(job):
    ranks, _, order, _ = job
    for r, rank in enumerate(ranks):
        assert rank["local_rows"] == sorted(RANKS[r])
        mine = {p for i, p in enumerate(order) if i % 4 in RANKS[r]}
        theirs = {p for i, p in enumerate(order) if i % 4 not in RANKS[r]}
        assert rank["reads"] and set(rank["reads"]) <= mine
        assert not set(rank["reads"]) & (theirs - mine)
        # the two batches trained on were read
        assert set(p for i, p in enumerate(order[:8])
                   if i % 4 in RANKS[r]) <= set(rank["reads"])


def test_multihost_trainer_equals_one_process(job):
    ranks, refs, _, tmp = job
    want = refs["multihost"]
    for rank in ranks:
        got = rank["final"]
        for k in ("val_loss", "train_loss"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3)
    assert ranks[0]["final"] == ranks[1]["final"]
    # rank 0 alone writes the checkpoint and the metrics
    assert os.path.exists(tmp / "ck_mh" / "last" / "state.pt")
    assert os.path.exists(tmp / "dv0" / "metrics.json")
    assert not os.path.exists(tmp / "dv1" / "metrics.json")


@pytest.mark.parametrize("placement", ["ddp", "fsdp"])
def test_trainer_two_devices_equals_one(job, placement):
    ranks, refs, _, _ = job
    want = refs["trainer"]
    for rank in ranks:
        got = rank["trainer"][placement]
        for k in ("val_loss", "train_loss"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
        assert got["val_AP"] == pytest.approx(want["val_AP"], abs=1e-6)


def test_multihost_checkpoint_restores_in_one_process(job):
    """The checkpoint rank 0 wrote restores into a one-process trainer."""
    _, _, _, tmp = job
    cfg = _trainer_config(tmp / "ck_mh")
    t = Trainer(Config(copy.deepcopy(cfg)), ListPipe([]), ListPipe([]),
                metrics=MetricsWriter(str(tmp / "dv_restore")), device="cpu")
    t.ckpt.restore(t.state, "last")
    assert t.state.step == 2
    assert all(torch.isfinite(p).all() for p in t.model.parameters())


def test_trainer_starts_the_group_from_a_coordinator(tmp_path):
    with socket.socket() as sock:   # a free port of this host
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k not in (
        "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
        "MASTER_ADDR", "MASTER_PORT")}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        p for p in (repo, env.get("PYTHONPATH")) if p))
    procs = []
    for rank in range(2):
        cfg = _trainer_config(tmp_path / "ck", devices=2, multihost=True,
                              coordinator=f"localhost:{port}",
                              num_processes=2, process_id=rank)
        torch.save({"config": cfg, "workdir": str(tmp_path)},
                   tmp_path / f"spec{rank}.pt")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests.torch_dist_worker",
             str(tmp_path / f"spec{rank}.pt"),
             str(tmp_path / f"out{rank}.pt")],
            env=env, cwd=repo, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    try:
        logs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    outs = [torch.load(tmp_path / f"out{r}.pt") for r in range(2)]
    assert [o["rank"] for o in outs] == [0, 1]
    for o in outs:
        assert (o["world"], o["backend"], o["mesh"], o["sum"],
                o["again"]) == (2, "gloo", 2, 3.0, True)
    assert [o["rows"] for o in outs] == [[0, 1], [2, 3]]


def test_dryrun_multichip_four():
    out = dryrun_multichip(4)
    assert out["mesh"] == {"data": 2, "fsdp": 2}
    assert np.isfinite(out["loss"]) and out["local_rows"] == [2, 2, 2, 2]
    assert out["detections"] == [8, 16, 4] and out["step"] == 1
    # the second mesh: data 1 x sp 2 x ep 2, a step and a spatial detect
    assert out["sp_ep"]["mesh"] == {"data": 1, "sp": 2, "ep": 2}
    assert np.isfinite(out["sp_ep"]["loss"])
    assert out["sp_ep"]["local_rows"] == 4
    # the third mesh: 4 pp stages, 4 microbatches of 2 rows, every rank
    assert np.isfinite(out["pp_loss"]) and out["pp"]["stages"] == 4
    assert out["pp"]["rows"] == 8 and len(out["pp"]["ranges"]) == 4
