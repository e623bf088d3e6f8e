"""The port's benchmark: ``python -m uavdet_tpu_torch.bench``.

The counterpart of the repository's ``bench.py`` (which runs the JAX
package): the same cells, flags and one-line contract, run by the port on
the card through its kernels. Stdout gets exactly one JSON line:

  {"metric": ..., "value": N, "unit": "fps", "vs_baseline": N or null}

The metric is the JAX bench's label plus `` [torch]``. Everything else
(the card's name and power limit, each window's reading, the launch counts,
the baseline's reading) goes to stderr, so the label is the same on every
machine.

Default run: DyYOLO @640 bs=16 (the model of params.yaml). ``--config N``:
  1  BaselineModel, RGB-only, batch 1 @ 640
  2  DyYOLO dual-stream: 8 RGB (1080x1920) + 8 infrared (512x640) uint8
     frames through ``preprocess_dual``; fps over the 16 frames
  3  DySOEM_SimFPN on the infrared stream, batch 32 @ 1280
  4  RTMUAVDet serving: preproc + detect + NMS, batch 8 @ 640
  5  RTMUAVDet training step (Adam), imgs/s
  6  DyYOLO training step (SGD, grad_batches 2, bf16 autocast), imgs/s
``--host-data``: JPEG files on disk -> ``DataPipeline`` -> the detector;
``--fit-rate``: ``Trainer.fit``'s sustained imgs/s with cached device
batches (and, on stderr, from the files on disk).

Timing: each timed cell runs ``--warmup`` calls (at least one: the first
call builds the kernels), then three windows of ``--iters`` calls issued
back to back (``utils.timing.time_total``: CUDA events on the card, with the
host's gaps between calls counted); the line reports the median window.
``--host-data`` times three windows of ``--epochs`` epochs by the host clock
after a synchronize; ``--fit-rate`` the median of the epochs after the
first.

``vs_baseline``: for the default cell, cfg1 and cfg2 the port's fps over
the fps of the reference's own PyTorch structure (``_bench_reference.py``:
eager NCHW, the dynamic conv as one ``F.conv2d(groups=B)``) holding the
port model's weights, in the same process, on the same frames, with the
port's decode and NMS, timed the same way. Elsewhere null: the repository
has no reference structure for those cells.

On the card the cells launch the port's kernels, and a run fails when a
kernel of its path was not launched in its timed calls. ``--device cuda``
(the default) without a card raises; ``--device cpu`` runs the kernels'
plain versions, everything in float32 (the smoke test's regime).
``--smoke`` shrinks every cell to test size: the tiny layer_config, 64 px
(48 px for DySOEM_SimFPN), batch 2, 2 iterations.

The JAX bench's ``--no-pallas-stem`` and ``--no-fold-early`` are not
ported: they switch the Pallas stem and the TPU lane-padding rewrites
(``fold_early``, ``fold_rtm``, ``fold_input_stem``), which the port does
not have; it runs the unfolded model, so its training labels read
``fold=False`` / ``fold_early=False``, the JAX labels of the same
computation.
"""

import argparse
import contextlib
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
from types import SimpleNamespace
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from . import kernels
from .models import BASELINE, DYSOEM, DYYOLO, DySOEM_SimFPN
from .models.registry import serving_dtype
from .ops.stem import detector_stem_fast_path
from .parallel.dryrun import TINY_CONFIG

# the keys of params.yaml the JAX bench reads (no PyYAML on the card; a test
# holds them equal to the file)
PARAMS = {"model": "DyYOLO", "seed": 211, "workers": 32}
HPARAMS = {"DyYOLO": DYYOLO, "baseline": BASELINE, "DySOEM_SimFPN": DYSOEM}
WINDOWS = 3
SUFFIX = " [torch]"
DUAL_HW = ((1080, 1920), (512, 640))            # RGB, infrared
SMOKE_SIZE, SMOKE_SOEM_SIZE, SMOKE_BATCH, SMOKE_ITERS = 64, 48, 2, 2
SMOKE_DUAL_HW = ((108, 192), (52, 64))
HOST_DATA_FRAMES, SMOKE_HOST_DATA_FRAMES = 48, 8
FIT_FRAMES, SMOKE_FIT_FRAMES = 56, 4
RTM_TARGET = (100.0, 100.0, 200.0, 200.0)       # pixels at 640 px
TRAIN_BOX = (0.3, 0.3, 0.6, 0.6)                # normalized


class Cell(NamedTuple):
    """One timed cell: ``run`` is one timed call, over ``items`` frames (or
    images), making ``calls`` detector calls (or steps)."""
    label: str
    run: Callable[[], object]
    items: int
    iters: int
    model: torch.nn.Module
    inputs: tuple
    kernels: tuple                  # the kernels its path launches
    calls: int = 1
    reference: Optional[Callable[[], Callable[[], object]]] = None


def _uint8(rng, shape, device) -> torch.Tensor:
    return torch.from_numpy(rng.integers(0, 256, size=shape,
                                         dtype=np.uint8)).to(device)


def _path_kernels(model, dtype) -> tuple:
    """The kernels a detector of ``model`` launches on the card."""
    names = ["nms"]
    if detector_stem_fast_path(model) is not None:
        names += ["stem_l1", "stem_l2"]
    if isinstance(model, DySOEM_SimFPN) and dtype == torch.bfloat16:
        names.append("dyconv")
    return tuple(names)


def _repeat(detect, frames, n):
    def run():
        out = None
        for _ in range(n):
            out = detect(*frames)
        return out
    return run


def detector_cell(name, hparams, batch, size, iters, device,
                  pre_nms_topk=512, suffix="", microbatch=None) -> Cell:
    """The default cell, cfg1 and cfg3 (``bench.py:51-87``): uint8 frames
    on the card -> ``make_detector`` -> Detections, ``batch // microbatch``
    sequential calls per timed call."""
    from ._bench_reference import reference_model
    from .inference import make_detector
    from .utils.seeding import seeded_model

    mb = microbatch or batch
    dtype = serving_dtype(device)
    model = seeded_model(name, hparams, 0, device, dtype=dtype)
    kw = dict(pre_nms_topk=pre_nms_topk, compute_dtype=dtype)
    frames = (_uint8(np.random.default_rng(0), (mb, size, size, 3), device),)
    n = batch // mb
    reference = None
    if name in ("DyYOLO", "baseline"):
        def reference():
            return _repeat(make_detector(reference_model(model), hparams,
                                         size, **kw), frames, n)
    label = (f"fps/chip end-to-end (preproc+detect+NMS) {name} @ {size}px "
             f"bs={batch}{suffix}"
             + (f" (microbatch {mb})" if mb != batch else ""))
    return Cell(label, _repeat(make_detector(model, hparams, size, **kw),
                               frames, n), batch, iters, model, frames,
                _path_kernels(model, dtype), n, reference)


def dual_cell(hparams, batch, size, iters, device, hw=DUAL_HW) -> Cell:
    """cfg2 (``bench.py:91-119``): B RGB and B infrared uint8 frames at
    their own sizes -> ``make_detector(dual=True)``; fps over 2B frames."""
    from ._bench_reference import reference_model
    from .inference import make_detector
    from .utils.seeding import seeded_model

    dtype = serving_dtype(device)
    model = seeded_model("DyYOLO", hparams, 0, device, dtype=dtype)
    rng = np.random.default_rng(0)
    frames = tuple(_uint8(rng, (batch, *s, 3), device) for s in hw)

    def reference():
        return _repeat(make_detector(reference_model(model), hparams, size,
                                     dual=True, compute_dtype=dtype),
                       frames, 1)

    label = (f"fps/chip end-to-end (dual-preproc+detect+NMS) DyYOLO @ "
             f"{size}px 2x{batch} native-res frames "
             "[cfg2 rgb+ir dual-stream]")
    detect = make_detector(model, hparams, size, dual=True,
                           compute_dtype=dtype)
    return Cell(label, _repeat(detect, frames, 1), 2 * batch, iters, model,
                frames, _path_kernels(model, dtype), 1, reference)


def rtm_detector_cell(batch, size, iters, device) -> Cell:
    """cfg4 (``bench.py:122-186``): ``make_rtm_detector``, the top 512
    candidates, NMS at IoU 0.5, 300 kept."""
    from .inference import make_rtm_detector
    from .models.rtm_uav_det import rtm_det_scales
    from .utils.seeding import seeded_rtm_model

    model = seeded_rtm_model(0, size, device)
    detect = make_rtm_detector(model, size, rtm_det_scales(size),
                               pre_nms_topk=512, nms_iou=0.5, max_det=300)
    frames = (_uint8(np.random.default_rng(0), (batch, size, size, 3),
                     device),)
    return Cell(f"fps/chip RTMUAVDet pipeline (preproc+detect+NMS) @ "
                f"{size}px bs={batch}", _repeat(detect, frames, 1), batch,
                iters, model, frames, ("nms",))


def rtm_train_cell(batch, size, iters, device) -> Cell:
    """cfg5 (``bench.py:188-233``): one Adam step (lr 1e-4) of
    ``make_rtm_train_step`` per call, on one target box per image."""
    from .models.rtm_uav_det import rtm_det_scales
    from .training.rtm import make_rtm_train_step, rtm_optimizer
    from .utils.seeding import seeded_rtm_model

    model = seeded_rtm_model(0, size, device, dtype=torch.float32)
    step = make_rtm_train_step(model, rtm_optimizer(model), size,
                               rtm_det_scales(size), serving_dtype(device))
    imgs = _uint8(np.random.default_rng(0), (batch, size, size, 3), device)
    box = np.asarray([RTM_TARGET], np.float32) * (size / 640)
    targets = torch.from_numpy(np.tile(box, (batch, 1, 1))).to(device)
    return Cell(f"RTMUAVDet train fwd+bwd imgs/s @ {size}px bs={batch} "
                "fold=False", lambda: step(imgs, targets), batch, iters,
                model, (imgs, targets), ())


def dyyolo_train_cell(hparams, batch, size, iters, device) -> Cell:
    """cfg6 (``bench.py:236-277``): one microbatch of ``make_train_step``
    per call (SGD from ``build_optimizer``, grad_batches 2, autocast to
    bf16 on the card) on uniform frames with one box each."""
    from .training import build_optimizer, init_state, make_train_step
    from .utils.datatypes import BatchData
    from .utils.seeding import seeded_model

    model = seeded_model("DyYOLO", hparams, 0, device, dtype=torch.float32)
    state = init_state(model, *build_optimizer(model.parameters(), hparams))
    step = make_train_step(model, hparams, size,
                           compute_dtype=serving_dtype(device),
                           grad_batches=2)
    rng = np.random.default_rng(0)
    batch_data = BatchData(
        image=torch.from_numpy(rng.uniform(size=(batch, size, size, 3))
                               .astype(np.float32)).to(device),
        boxes=torch.from_numpy(np.tile(np.asarray([TRAIN_BOX], np.float32),
                                       (batch, 1, 1))).to(device),
        box_mask=torch.ones((batch, 1), dtype=torch.bool, device=device))
    return Cell(f"DyYOLO train fwd+bwd imgs/s @ {size}px bs={batch} "
                "accum=2 fold_early=False",
                lambda: step(state, batch_data)["loss"], batch, iters, model,
                (batch_data,), ())


def _note(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _check_launches(names, calls: int, device) -> None:
    """Launch counts since the last reset on stderr; on the card, raises
    when a kernel of the path counted none."""
    counts = kernels.launch_counts()
    _note("launches: " + json.dumps({"calls": calls, "counts": counts}))
    if torch.device(device).type != "cuda":
        return
    missing = [k for k in names if counts[k] == 0]
    if missing:
        raise RuntimeError(f"kernels {missing} of this cell's path were not "
                           f"launched in {calls} calls: {counts}")


def _windows(run, items: int, iters: int, warmup: int, device,
             what: str) -> float:
    """Rates (items per second) of three windows of ``iters`` calls after
    ``warmup`` calls (at least one: the first builds the kernels and loads
    the libraries); each on stderr, the median returned."""
    from .utils.timing import time_total
    t0 = time.perf_counter()
    for _ in range(max(warmup, 1)):
        run()
    _sync(device)
    _note(f"{what}: warm-up of {max(warmup, 1)} calls "
          f"{time.perf_counter() - t0} s")
    rates = [items * iters / time_total(run, iters, 0, device)
             for _ in range(WINDOWS)]
    _note(f"{what}: windows of {iters} calls {rates} /s, median "
          f"{statistics.median(rates)}")
    return statistics.median(rates)


def measure(cell: Cell, warmup: int, device) -> tuple:
    """-> (rate, vs_baseline) of a timed cell: the port's windows and launch
    check, then the reference structure's windows where it has one."""
    kernels.reset_launch_counts()
    rate = _windows(cell.run, cell.items, cell.iters, warmup, device,
                    "port")
    _check_launches(cell.kernels,
                    (max(warmup, 1) + WINDOWS * cell.iters) * cell.calls,
                    device)
    if cell.reference is None:
        return rate, None
    ref = _windows(cell.reference(), cell.items, cell.iters, warmup,
                   device, "reference-structure eager model")
    return rate, rate / ref


def host_data(name, hparams, size, batch, epochs, workers, device,
              n_frames=HOST_DATA_FRAMES) -> tuple:
    """``--host-data`` (``bench.py:280-341``): JPEG files of a synthetic
    tree -> ``DataPipeline`` -> ``make_detector``; -> (label, fps). The
    pipeline's frames/s alone go to stderr, read after the warm-up epoch
    (the JAX bench reads them first; here the first pass also sets up the
    read threads' nvJPEG states)."""
    from .data import DataPipeline, build_index, make_synthetic_dataset
    from .inference import make_detector
    from .utils.seeding import seeded_model

    dtype = serving_dtype(device)
    root = tempfile.mkdtemp(prefix="uavdet_torch_hostbench_")
    try:
        make_synthetic_dataset(root, splits=("train",), n_seq=2,
                               n_frames=n_frames, img_size=size,
                               device=device)
        pipe = DataPipeline(build_index(os.path.join(root, "train")), size,
                            batch, train=False, workers=workers,
                            drop_last=True, device=device)
        model = seeded_model(name, hparams, 0, device, dtype=dtype)
        detect = make_detector(model, hparams, size, compute_dtype=dtype)

        def run_epoch():
            for b in pipe:
                detect(b.image)

        run_epoch()   # warm-up: the kernels' build, the decoder states
        _sync(device)
        t0 = time.perf_counter()
        n = sum(b.image.shape[0] for b in pipe)
        _sync(device)
        decoder = "nvJPEG" if torch.device(device).type == "cuda" else "PIL"
        _note(f"host decode ceiling: {n / (time.perf_counter() - t0)} "
              f"frames/s (the pipeline alone, after the warm-up epoch; "
              f"decoder {decoder}, workers {workers}); device-only "
              "headline: the default cell")
        kernels.reset_launch_counts()
        rates = []
        for _ in range(WINDOWS):
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(epochs):
                run_epoch()
            _sync(device)
            rates.append(epochs * len(pipe) * batch
                         / (time.perf_counter() - t0))
        _note(f"port: windows of {epochs} epochs {rates} frames/s, median "
              f"{statistics.median(rates)}")
        _check_launches(_path_kernels(model, dtype),
                        WINDOWS * epochs * len(pipe), device)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return (f"fps end-to-end WITH host data path (jpeg decode->detect) "
            f"{name} @ {size}px bs={batch} over {epochs} epochs "
            "[host-bound]", statistics.median(rates))


class CachedPipe:
    """A DataPipeline whose first epoch's batches (on the device) are kept
    and replayed by every later epoch: the Trainer's loop without the
    decode (``bench.py:344-364``)."""

    def __init__(self, inner):
        self.inner = inner
        self._cache = None

    def __len__(self):
        return len(self.inner)

    def __iter__(self):
        if self._cache is None:
            self._cache = list(self.inner)
        yield from self._cache


def _namespace_dict(ns):
    if isinstance(ns, SimpleNamespace):
        return {k: _namespace_dict(v) for k, v in vars(ns).items()}
    return ns


def fit_rate(hparams, epochs, batch, size, device,
             n_frames=FIT_FRAMES) -> tuple:
    """``--fit-rate`` (``bench.py:367-428``): ``Trainer.fit`` at cfg6's
    configuration (DyYOLO, grad_batches 2, no validation), once over
    cached device batches and once over the files on disk; each rate the
    median of the epochs after the first. -> (label, the cached rate)."""
    from .data import DataPipeline, build_index, make_synthetic_dataset
    from .training import MetricsWriter, Trainer
    from .utils.config import Config

    dtype = serving_dtype(device)
    root = tempfile.mkdtemp(prefix="uavdet_torch_fitbench_")
    try:
        make_synthetic_dataset(root, splits=("train", "val"), n_seq=2,
                               n_frames=n_frames, img_size=size,
                               device=device)
        recs = build_index(os.path.join(root, "train"))
        val = DataPipeline(build_index(os.path.join(root, "val"))[:batch],
                           size, batch, train=False, seed=1, device=device)
        config = Config({
            "dataset": {"batch_size": batch, "image_size": [size, size]},
            "train": {"seed": PARAMS["seed"], "trainer": {
                "epochs": epochs, "grad_batches": 2,
                "precision": "bf16" if dtype == torch.bfloat16 else "32",
                "train_batches": 1.0, "val_batches": 1,
                "val_check_interval": 1.0,
                "check_val_every_n_epoch": 10 ** 6,   # the train loop alone
                "nan_guard": False, "grad_clip_val": None,
                "profiler": None},
                "checkpoint": {"dir": os.path.join(root, "ck"),
                               "monitor": "val_loss", "mode": "min"}},
            "model": {"name": "DyYOLO",
                      "hparams": _namespace_dict(hparams)}})
        rates = {}
        for mode in ("cached", "disk"):
            train = DataPipeline(recs, size, batch, train=True, seed=2,
                                 workers=PARAMS["workers"], device=device)
            pipe = CachedPipe(train) if mode == "cached" else train
            trainer = Trainer(config, pipe, val, device=device,
                              metrics=MetricsWriter(
                                  os.path.join(root, f"dv_{mode}")))
            kernels.reset_launch_counts()
            trainer.fit()
            _sync(device)
            _check_launches((), epochs * len(train), device)
            n_imgs = len(train) * batch
            per_epoch = [n_imgs / s for s in trainer.epoch_seconds]
            rates[mode] = statistics.median(per_epoch[1:])
            _note(f"fit-rate[{mode}]: epochs {per_epoch} imgs/s (the first "
                  f"builds), sustained median {rates[mode]}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _note(f"fit-rate: cached {rates['cached']} imgs/s (the Trainer's loop, "
          f"cfg6-comparable) | on disk {rates['disk']} imgs/s (with the "
          "decode)")
    return (f"Trainer.fit sustained img/s (cached device batches) DyYOLO "
            f"@{size}px bs={batch} accum=2 fold_early=False", rates["cached"])


def emit(metric: str, value: float, vs_baseline: Optional[float]) -> None:
    print(json.dumps({
        "metric": metric + SUFFIX,
        "value": round(value, 1),
        "unit": "fps",
        "vs_baseline": None if vs_baseline is None else round(vs_baseline,
                                                              3),
    }), flush=True)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="The port's end-to-end benchmark: one JSON line on "
        "stdout. The JAX bench's --no-pallas-stem and --no-fold-early are "
        "not ported: they switch the Pallas stem and TPU lane-padding "
        "rewrites that the port does not have.")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--input", type=int, default=640)
    ap.add_argument("--model", default=None, choices=sorted(HPARAMS),
                    help="model of the default cell (default: params.yaml's,"
                    f" {PARAMS['model']})")
    ap.add_argument("--smoke", action="store_true",
                    help="every cell at test size: the tiny layer_config, "
                    f"{SMOKE_SIZE} px ({SMOKE_SOEM_SIZE} for DySOEM_SimFPN), "
                    f"batch {SMOKE_BATCH}, {SMOKE_ITERS} iterations")
    ap.add_argument("--microbatch", type=int, default=None,
                    help="cfg3: sequential sub-batch size (default: the "
                    "whole batch of 32 in one call)")
    ap.add_argument("--host-data", action="store_true",
                    help="end-to-end fps with the host data path (JPEG "
                    "files -> DataPipeline -> detector), windows of "
                    "--epochs epochs")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--workers", type=int, default=None,
                    help="--host-data: read and decode threads (default: "
                    "the CPU count)")
    ap.add_argument("--config", type=int, default=None,
                    choices=[1, 2, 3, 4, 5, 6],
                    help="workload config (see the module docstring)")
    ap.add_argument("--fit-rate", action="store_true",
                    help="Trainer.fit sustained imgs/s (cached device "
                    "batches, and from disk on stderr), cfg6-comparable")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; cpu runs the "
                    "kernels' plain versions)")
    return ap.parse_args(argv)


def _smoke_hparams(name: str):
    if name == "DySOEM_SimFPN":
        return DYSOEM
    tiny = tuple(tok[1:] if name == "baseline" and tok[0] == "DyConv"
                 else tok for tok in TINY_CONFIG)
    return SimpleNamespace(**dict(vars(HPARAMS[name]), layer_config=tiny))


def build_cell(args) -> Cell:
    """The timed cell of ``args``: the default cell or ``--config N``."""
    smoke, dev = args.smoke, args.device

    def hp(name):
        return _smoke_hparams(name) if smoke else HPARAMS[name]

    def size(full):
        return SMOKE_SIZE if smoke else full

    def batch(full):
        return SMOKE_BATCH if smoke else full

    def iters(full):
        return SMOKE_ITERS if smoke else full

    if args.config is None:
        name = args.model or PARAMS["model"]
        return detector_cell(name, hp(name), batch(args.batch),
                             size(args.input), iters(args.iters), dev,
                             pre_nms_topk=256 if smoke else 512)
    if args.config == 1:
        return detector_cell("baseline", hp("baseline"), batch(1), size(640),
                             iters(args.iters), dev, suffix=" [cfg1 rgb]")
    if args.config == 2:
        return dual_cell(hp("DyYOLO"), batch(8), size(640), iters(args.iters),
                         dev, SMOKE_DUAL_HW if smoke else DUAL_HW)
    if args.config == 3:
        return detector_cell(
            "DySOEM_SimFPN", hp("DySOEM_SimFPN"), batch(32),
            SMOKE_SOEM_SIZE if smoke else 1280, iters(min(args.iters, 10)),
            dev, suffix=" [cfg3 ir thermal]", microbatch=args.microbatch)
    if args.config == 4:
        return rtm_detector_cell(batch(8), size(640), iters(20), dev)
    if args.config == 5:
        return rtm_train_cell(batch(8), size(640), iters(10), dev)
    return dyyolo_train_cell(hp("DyYOLO"), batch(8), size(640), iters(10),
                             dev)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device is visible "
                               "(--device cpu runs the plain versions)")
        from .utils.timing import card_line
        _note(f"card: {card_line()}; torch {torch.__version__} cuda "
              f"{torch.version.cuda}")
    else:
        _note(f"device: {device} (no card; the kernels' plain versions)")
    # everything but the one JSON line goes to stderr (Trainer.fit prints)
    with contextlib.redirect_stdout(sys.stderr):
        if args.host_data:
            name = args.model or PARAMS["model"]
            label, value = host_data(
                name, _smoke_hparams(name) if args.smoke else HPARAMS[name],
                SMOKE_SIZE if args.smoke else args.input,
                SMOKE_BATCH if args.smoke else args.batch, args.epochs,
                args.workers or os.cpu_count() or 1, device,
                SMOKE_HOST_DATA_FRAMES if args.smoke else HOST_DATA_FRAMES)
            vs = None
        elif args.fit_rate:
            label, value = fit_rate(
                _smoke_hparams("DyYOLO") if args.smoke else DYYOLO,
                max(args.epochs, 3), SMOKE_BATCH if args.smoke else 8,
                SMOKE_SIZE if args.smoke else args.input, device,
                SMOKE_FIT_FRAMES if args.smoke else FIT_FRAMES)
            vs = None
        else:
            t0 = time.perf_counter()
            cell = build_cell(args)
            _note(f"cell built in {time.perf_counter() - t0} s")
            label = cell.label
            value, vs = measure(cell, args.warmup, device)
        if vs is None:
            _note("vs_baseline: null (the repository has no reference "
                  "structure for this cell)")
    emit(label, value, vs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
