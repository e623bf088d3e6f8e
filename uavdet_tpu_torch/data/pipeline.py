"""The data pipeline: manifest -> batches of frames on the device.

The port of ``uavdet_tpu/data/pipeline.py`` ``DataPipeline``, with the same
constructor surface and semantics: epoch order from
``default_rng(seed + epoch)``; with ``workers > 1`` one RNG per sample from
``SeedSequence([seed, epoch]).spawn(n)``, else the order's RNG shared in
sequence; samples whose boxes all degenerate dropped (the reference
collate's drop-empty); boxes padded to ``max_boxes`` with a mask,
normalized xyxy; ``fmt`` 'yolo' or 'custom'; ``drop_last``; ``len()``.

What happens where:

* a pool of ``workers`` threads, a bounded window ahead: file reads and
  decodes (PIL on the CPU; nvJPEG on the card, one decoder state per
  thread, onto a side CUDA stream);
* host: from each frame's size (on the card read from the JPEG header when
  its output is allocated), the RNG draws and the box arithmetic
  (``frames.box_path``, numpy, the JAX package's operations), so a batch's
  membership and boxes do not depend on the device; boxes and masks staged
  in pinned buffers;
* device (``device``, the card unless the caller names the CPU): the frame
  stage (``frames.frame_stage``: resize, training affine, /255).

Mosaic (``mosaic=True``, training only; validation ignores it, as in the
JAX package): each position draws four record indices from its RNG
(``integers(0, len(records), size=4)``), then its affine, in the JAX
package's order; its own record is not read. The four sources are read and
decoded; ``mosaic.mosaic_layout`` of their sizes and manifest boxes gives
the placed boxes on the host (then the affine, the 1 px degenerate drop and
drop-empty, as the JAX package's geometry-only replay does), and on the
device ``mosaic.mosaic_canvas`` (Lanczos-4 into the quadrants, cv2's bit
for bit) makes the (S, S) canvas that the frame stage takes: its resize is
the identity at (S, S), then the affine and /255.

The hand-off on the card: a producer thread runs the frame stage on the
side stream and copies boxes and masks ``non_blocking`` from pinned memory
on it; it records one event per batch. ``__iter__``
makes the consumer's current stream wait on that event and calls
``record_stream`` on every tensor handed over, so the caching allocator
does not reuse their memory early. ``prefetch`` batches are in flight.
Batches come out as ``BatchData`` on the device (image (B, S, S, 3) float32
in [0, 1]), so ``Trainer._to_device`` copies nothing. An error in the
producer (a read, a decode, a build of the nvJPEG library) is raised by
``__iter__``.

The sharded decode (``set_local_rows(rows)``, multi-device training): the
host replays the whole global stream from each frame's header alone
(``frames.image_size``: PIL's on the CPU, nvJPEG's on the card), so
membership, boxes, the affines and the mosaic layouts are decided exactly
as above; then only the files of the batch rows in ``rows`` are read and
decoded, and each batch holds those rows alone, with their boxes and masks
(where the JAX package zero-fills the other rows for
``jax.make_array_from_callback``; a DDP rank does not need them). A remote
``fs`` returns False and decodes everything, as in the JAX package. The JAX
package's native C++ loader has no counterpart (nvJPEG and the device
resize do its job on the card).
"""

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional

import numpy as np
import torch

from ..utils.datatypes import BatchData
from . import frames
from .mosaic import mosaic_canvas, mosaic_layout
from .remote import read_bytes

_END = object()


class _Failure:
    def __init__(self, error: BaseException):
        self.error = error


def _put(q: queue.Queue, item, stop: threading.Event) -> bool:
    """Put unless the consumer has gone (``stop``); -> whether it was put."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.05)
            return True
        except queue.Full:
            continue
    return False


class DataPipeline:
    """Epoch iterator over a manifest producing BatchData on ``device``."""

    def __init__(self, records: List[dict], input_size: int, batch_size: int,
                 train: bool, seed: int = 11, max_boxes: int = 8,
                 mosaic: bool = False, shuffle: Optional[bool] = None,
                 drop_last: bool = True, fs=None, prefetch: int = 2,
                 workers: int = 1, fmt: str = "yolo", device="cuda"):
        if fmt not in ("yolo", "custom"):
            raise ValueError(f"unknown dataset format: {fmt!r}")
        self.device = torch.device(device)
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"DataPipeline runs on the CPU or a CUDA "
                             f"device, not {self.device}")
        self.records = records
        self.input_size = input_size
        self.batch_size = batch_size
        self.train = train
        self.mosaic = bool(mosaic) and train
        self.max_boxes = max_boxes
        self.shuffle = train if shuffle is None else shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.fs = fs
        # one remote filesystem (a paramiko channel, an fsspec instance) is
        # not safe for concurrent reads: they are serialized
        self._fs_lock = threading.Lock()
        self.prefetch = max(1, int(prefetch))
        self.workers = max(1, int(workers))
        self.fmt = fmt
        self._epoch = 0
        # the batch rows whose pixels this process decodes; None: all
        self.local_rows = None

    def set_local_rows(self, rows) -> bool:
        """Decode and yield only the batch rows ``rows`` (a process's rows,
        ``parallel.local_batch_rows``); membership stays the global
        stream's, replayed from the headers. -> False (and everything
        decoded) for a remote ``fs``, whose headers cannot be read without
        fetching the objects."""
        if self.fs is not None:
            self.local_rows = None
            return False
        self.local_rows = frozenset(int(r) for r in rows)
        return True

    def __len__(self):
        n = len(self.records) // self.batch_size
        if not self.drop_last and len(self.records) % self.batch_size:
            n += 1
        return n

    # ------------------------------------------------------------- host

    def _read(self, path: str) -> bytes:
        if self.fs is not None:
            with self._fs_lock:
                return read_bytes(path, self.fs)
        return read_bytes(path)

    def _load(self, path: str, stream=None) -> torch.Tensor:
        """In a read thread: the decoded (H, W, 3) uint8 frame. On the card
        nvJPEG decodes it onto the producer's side ``stream``; its shape is
        known on the host at once (from the JPEG header)."""
        data = self._read(path)
        if stream is None:
            return frames.decode_cpu(data)
        with torch.cuda.device(self.device), torch.cuda.stream(stream):
            return frames.decode([data], self.device)[0]

    def _ahead(self, ex, groups, fn, *args) -> Iterator[list]:
        """``fn(path, *args)`` of each record of each group of record
        indices in ``groups`` (a decoded frame, a header's size), in order,
        the calls running ahead in the pool by a bounded window of
        groups."""
        ahead = max(self.batch_size * 4, self.workers * 4)
        pending = collections.deque()
        it = iter(groups)
        while True:
            while len(pending) < ahead:
                group = next(it, None)
                if group is None:
                    break
                pending.append([ex.submit(
                    fn, self.records[i]["img_path"], *args)
                    for i in group])
            if not pending:
                return
            yield [fut.result() for fut in pending.popleft()]

    def _mosaic_draws(self, order, rng, rngs) -> list:
        """Per position: its four source indices, then its affine, drawn
        from the position's RNG (the order's RNG shared in sequence where
        ``workers`` is 1), as the JAX package draws them."""
        draws = []
        for pos in range(len(order)):
            r = rngs[pos] if rngs is not None else rng
            idx = r.integers(0, len(self.records), size=4)
            draws.append((idx, frames.affine_matrix(r, self.input_size)))
        return draws

    def _order(self) -> tuple:
        """The epoch's RNG, its order of the records, and with ``workers``
        above 1 one RNG per position (None otherwise)."""
        rng = np.random.default_rng(self.seed + self._epoch)
        order = (rng.permutation(len(self.records)) if self.shuffle
                 else np.arange(len(self.records)))
        rngs = None
        if self.workers > 1:
            rngs = [np.random.default_rng(s) for s in np.random.SeedSequence(
                [self.seed, self._epoch]).spawn(len(order))]
        return rng, order, rngs

    def _sources(self, pos, order, draws) -> list:
        """The record indices position ``pos`` reads: its own, or in mosaic
        mode its four drawn sources."""
        return ([int(j) for j in draws[pos][0]] if self.mosaic
                else [int(order[pos])])

    def _geometry(self, pos, sources, sizes, draws, rng, rngs) -> tuple:
        """Position ``pos``'s (float32 boxes, affine matrix or None, mosaic
        layout or None) from the (height, width) ``sizes`` of its
        ``sources``: the host's part of the sample, as the JAX package
        computes it."""
        s = self.input_size
        if self.mosaic:
            layout = mosaic_layout(
                sizes, [self.records[j]["bbox"] for j in sources], (s, s))
            placed = np.asarray([b for *_, b in layout],
                                np.float32).reshape(-1, 4)
            boxes, mat = frames.box_path(placed, s, s, s, True,
                                         mat=draws[pos][1])
            return boxes, mat, layout
        (h, w), = sizes
        boxes, mat = frames.box_path(
            np.asarray([self.records[sources[0]]["bbox"]], np.float32), w, h,
            s, self.train, rngs[pos] if rngs is not None else rng)
        return boxes, mat, None

    def _plan(self, ex, stream=None) -> Iterator[list]:
        """One epoch's batches: lists of (decoded frame, or in mosaic mode
        the four decoded sources and their layout; float32 boxes; affine
        matrix or None) of the samples that keep a box; the boxes and
        membership from the host alone."""
        rng, order, rngs = self._order()
        draws = self._mosaic_draws(order, rng, rngs) if self.mosaic else None
        groups = [self._sources(pos, order, draws)
                  for pos in range(len(order))]
        kept = []
        for pos, loaded in enumerate(self._ahead(ex, groups, self._load,
                                                     stream)):
            boxes, mat, layout = self._geometry(
                pos, groups[pos], [tuple(f.shape[:2]) for f in loaded],
                draws, rng, rngs)
            if len(boxes) == 0:
                continue  # drop-empty (collate parity, both reference fns)
            kept.append(((loaded, layout) if self.mosaic else loaded[0],
                         boxes, mat))
            if len(kept) == self.batch_size:
                yield kept
                kept = []
        if kept and not self.drop_last:
            yield kept
        self._epoch += 1

    def _plan_local(self, ex, stream=None) -> Iterator[list]:
        """``_plan`` for ``local_rows``: each position's boxes and draws
        from its header's size (its four sources' in mosaic mode), the
        headers read in the pool a window of positions ahead, in the same
        order; of each batch only the rows in ``local_rows`` read and
        decoded in the pool, a window of batches ahead."""
        rng, order, rngs = self._order()
        draws = self._mosaic_draws(order, rng, rngs) if self.mosaic else None
        groups = [self._sources(pos, order, draws)
                  for pos in range(len(order))]
        pending = collections.deque()

        def submit(kept):
            rows = [r for r in range(len(kept)) if r in self.local_rows]
            pending.append([(
                [ex.submit(self._load, self.records[j]["img_path"], stream)
                 for j in kept[r][0]], kept[r]) for r in rows])

        def resolved():
            out = []
            for futs, (_, layout, boxes, mat) in pending.popleft():
                loaded = [f.result() for f in futs]
                out.append(((loaded, layout) if self.mosaic else loaded[0],
                            boxes, mat))
            return out

        kept = []
        for pos, sizes in enumerate(self._ahead(ex, groups, self._size)):
            boxes, mat, layout = self._geometry(pos, groups[pos], sizes,
                                                draws, rng, rngs)
            if len(boxes) == 0:
                continue  # drop-empty, the same decision on every process
            kept.append((groups[pos], layout, boxes, mat))
            if len(kept) == self.batch_size:
                submit(kept)
                kept = []
                if len(pending) > self.prefetch:
                    yield resolved()
        if kept and not self.drop_last:
            submit(kept)
        while pending:
            yield resolved()
        self._epoch += 1

    def _size(self, path: str) -> tuple:
        """(height, width) of a local frame from its header alone."""
        return frames.image_size(path, self.device)

    def _collate_boxes(self, boxes_list) -> tuple:
        b = len(boxes_list)
        if self.fmt == "custom":
            # _custom_collate_fn contract (reference _helper.py:113-129):
            # torch.stack over per-sample box tensors — requires equal
            # box counts per sample
            counts = {len(bx) for bx in boxes_list}
            if len(counts) > 1:
                raise ValueError(
                    "format='custom' stacks box tensors; got unequal "
                    f"per-sample box counts {sorted(counts)}")
        boxes = np.zeros((b, self.max_boxes, 4), np.float32)
        mask = np.zeros((b, self.max_boxes), bool)
        for i, bx in enumerate(boxes_list):
            n = min(len(bx), self.max_boxes)
            boxes[i, :n] = bx[:n] / self.input_size  # normalized xyxy
            mask[i, :n] = True
        return boxes, mask

    # ----------------------------------------------------------- device

    def _materialize(self, kept) -> BatchData:
        """One planned batch on the device: the frame stage over its
        decoded frames or mosaic canvases (on the card inside the
        producer's side stream), and
        the boxes and masks, staged in pinned memory there."""
        s = self.input_size
        if not kept:   # a process without rows in this batch
            return BatchData(
                image=torch.zeros((0, s, s, 3), device=self.device),
                boxes=torch.zeros((0, self.max_boxes, 4), device=self.device),
                box_mask=torch.zeros((0, self.max_boxes), dtype=torch.bool,
                                     device=self.device))
        pixels = ([mosaic_canvas(*k[0], (s, s)) for k in kept]
                  if self.mosaic else [k[0] for k in kept])
        image = frames.frame_stage(
            pixels, s, [k[2] for k in kept] if self.train else None)
        boxes, mask = self._collate_boxes([k[1] for k in kept])
        boxes, mask = torch.from_numpy(boxes), torch.from_numpy(mask)
        if self.device.type == "cuda":
            boxes = boxes.pin_memory().to(self.device, non_blocking=True)
            mask = mask.pin_memory().to(self.device, non_blocking=True)
        return BatchData(image=image, boxes=boxes, box_mask=mask)

    def _produce(self, q: queue.Queue, stop: threading.Event) -> None:
        ex = ThreadPoolExecutor(self.workers)
        plan = self._plan if self.local_rows is None else self._plan_local
        try:
            if self.device.type == "cuda":
                from .jpeg import codec
                codec()   # made once, before the read threads share it
                side = torch.cuda.Stream(self.device)
                with torch.cuda.device(self.device), torch.cuda.stream(side):
                    for kept in plan(ex, side):
                        batch = self._materialize(kept)
                        event = torch.cuda.Event()
                        event.record(side)
                        if not _put(q, (batch, event), stop):
                            return
            else:
                for kept in plan(ex):
                    if not _put(q, (self._materialize(kept), None), stop):
                        return
        except BaseException as e:   # handed to the consumer, which raises
            _put(q, _Failure(e), stop)
        finally:
            ex.shutdown(wait=True, cancel_futures=True)
            _put(q, _END, stop)

    def __iter__(self) -> Iterator[BatchData]:
        """Iterate one epoch's batches, ``prefetch`` of them in flight."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        t = threading.Thread(target=self._produce, args=(q, stop),
                             daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    break
                if isinstance(item, _Failure):
                    raise item.error
                batch, event = item
                if event is not None:
                    cur = torch.cuda.current_stream(self.device)
                    cur.wait_event(event)
                    for tensor in batch:
                        tensor.record_stream(cur)
                yield batch
        finally:
            stop.set()   # a consumer that stops early ends the producer
            t.join()
