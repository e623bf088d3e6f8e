"""End-to-end inference of the port: frames -> detections.

Port of ``uavdet_tpu/inference.py`` (``preprocess``, ``preprocess_dual``,
``decode_topk_global``, ``make_detector``) for a DyYOLO, a BaselineModel or
a DySOEM_SimFPN:

  1. DyYOLO: uint8 NHWC frames at the detector's size go straight into the
     stem's kernel A (/255 is folded into its weights); other frames are
     resized and normalized by ``preprocess`` first. Any other model: every
     frame goes through ``preprocess``, which only normalizes (/255) frames
     that are already at the detector's size;
  2. DyYOLO: the two-pass dynamic-conv stem (``ops/stem.py``, kernels A and
     B), then the rest of the model. A model without that stem runs whole;
     a bf16 DySOEM_SimFPN runs its three SOEMs through kernel D
     (``ops/dyconv.py``);
  3. one global top-k over the objectness logits of all heads, and the
     decode of the survivors only; the head strides come from the shapes;
  4. greedy NMS (``ops/nms.py``, the NMS kernel), fixed-shape Detections.

The dual-stream detector (``dual=True``) takes an RGB and an infrared batch
at their native sizes, brings both to the detector's grid in
``preprocess_dual`` and detects them as one batch of 2B frames; with DyYOLO
the preprocessed bf16 frames go through the stem kernels.

A model whose parameters live on a CUDA device runs the kernels; on the CPU
the same code runs their plain PyTorch versions. ``Detector`` is the same
program as one ``nn.Module`` holding the model, which ``export.py`` traces.

``decode_all_heads`` and ``decode_topk_heads`` (with ``_topk_wide``) are the
JAX package's other two decodes, kept with its contracts; no detector path
calls them (the detector keeps ``decode_topk_global``).

With a ``mesh`` (``parallel.make_mesh``) every detector is the sharded
detect of the JAX package's ``make_detector(mesh=)``: each rank takes the
global batch, detects its own rows (``parallel.row_block`` of its place on
the data x fsdp x ep axes) through the same detector, so kernels A, B and
C run per rank on its rows, and the fixed-shape ``Detections`` of every
rank are gathered in the global order onto every rank. The model must hold
its full weights (a plain module, not an FSDP2 one and without ``ep``
slices: kernels A, B and D read the expert weights as plain tensors).

With ``spatial=True`` as well (the JAX ``make_detector(mesh=,
spatial=True)``), each rank of an ``sp`` group runs the body on its band of
the frames' rows (``parallel.row_band``): DyYOLO's stem through kernels A
and B on the band with its halo rows, cut from the frames every rank holds
(``ops.stem.fused_stem_rows``), then the tail with every 3x3 conv
exchanging its halo; a DySOEM_SimFPN's SOEMs through kernel D on halo'd
bands; a BaselineModel whole. The heads' bands are gathered over the group
(``parallel.gather_rows``), and every rank decodes and runs kernel C on
its rows' whole heads, once per request. Unlike the JAX package, which
turns its Pallas stem off under a mesh, the kernels run on every rank.

``make_rtm_detector`` serves an RTMUAVDet, which ``make_detector`` does not
take (as in the JAX package, whose only RTMUAVDet detector is the one of
its benchmark, ``bench.py``'s cfg4): ``preprocess``, the eval-mode
forward, the decoded heads to pixels, per image the top ``pre_nms_topk`` by
objectness (``_topk_wide``: the lower index first on ties, as
``lax.top_k``) and greedy NMS through ``batched_nms``, so the NMS kernel on
the card.
"""

from functools import lru_cache
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .ops.decode import decode_predictions
from .ops.nms import batched_nms, nms_alive
from .ops.resize import bilinear_resize
from .ops.stem import STEM_HALO, detector_stem_fast_path
from .utils.datatypes import DetectionResults, Detections


def preprocess(images: torch.Tensor, input_size: int,
               compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """uint8/float NHWC frames -> (B, S, S, C) in [0, 1], compute dtype."""
    x = images.float()
    if images.dtype == torch.uint8:
        x = x / 255.0
    return bilinear_resize(x, input_size, input_size).to(compute_dtype)


def preprocess_dual(rgb: torch.Tensor, ir: torch.Tensor, input_size: int,
                    compute_dtype: torch.dtype = torch.bfloat16
                    ) -> torch.Tensor:
    """Both modalities (e.g. RGB 1080x1920 and infrared 512x640 frames)
    resized to the detector's grid, normalized and stacked modality-major:
    out[:B] are the RGB frames, out[B:] the infrared ones."""
    return torch.cat([preprocess(rgb, input_size, compute_dtype),
                      preprocess(ir, input_size, compute_dtype)], dim=0)


@lru_cache(maxsize=16)
def _head_tables(device: torch.device, heads: tuple, anchors: tuple,
                 scales: tuple) -> dict:
    """Per-head decode tables on ``device``, built once per detector shape:
    building them at every call would copy them from the host each time,
    and a copy from pageable host memory makes the host wait for the card.

    heads: (A, H, W) per head; anchors: (A*heads, 2) pixels; scales: per
    head. Read-only: every caller of the cache shares them.
    """
    offs = [0]
    for a, h, w in heads:
        offs.append(offs[-1] + a * h * w)

    def t(values, dtype=torch.int64):
        return torch.tensor(values, dtype=dtype, device=device)

    return dict(n=offs[-1], bounds=t(offs[1:-1]), off=t(offs[:-1]),
                hw=t([h * w for _, h, w in heads]),
                ww=t([w for _, _, w in heads]),
                scale=t(scales, torch.float32),
                anchors=t(anchors, torch.float32))


def _candidate_boxes(sel, gx, gy, scale, aw, ah) -> torch.Tensor:
    """Box logits (B, k, 4) of candidates in grid cells (gx, gy) of a head
    of stride ``scale`` with anchors (aw, ah) in pixels -> absolute-pixel
    xyxy f32 (reference model/_base.py:214-241)."""
    s = torch.sigmoid(sel.float())
    cx = (s[..., 0] * 2.0 - 0.5 + gx) * scale
    cy = (s[..., 1] * 2.0 - 0.5 + gy) * scale
    w_ = (s[..., 2] * 2.0) ** 2 * aw
    h_ = (s[..., 3] * 2.0) ** 2 * ah
    return torch.stack([cx - w_ / 2, cy - h_ / 2,
                        cx + w_ / 2, cy + h_ / 2], dim=-1)


def decode_all_heads(outs, anchors, head_scales: Sequence[int],
                     bbox_loss_fn: str = "mse"):
    """Every candidate of every head decoded to absolute-pixel xyxy.

    -> boxes (B, N, 4) f32, scores (B, N) f32 with N = sum over heads of
    A * H * W, head-major. Both ``bbox_loss_fn`` modes decode to the same
    pixels: 'mse' adds the grid and anchor terms that 'ciou''s
    ``decode_predictions`` already holds.
    """
    all_boxes, all_scores = [], []
    for h, out in enumerate(outs):
        scale = head_scales[h]
        p = out.bbox.float()
        sa = torch.tensor(np.asarray(anchors[h], np.float32),
                          device=p.device) / scale       # grid units
        dec = decode_predictions(p, sa, bbox_loss_fn)    # cxcywh
        if bbox_loss_fn != "ciou":
            hh, ww = p.shape[-3], p.shape[-2]
            gy, gx = torch.meshgrid(
                torch.arange(hh, dtype=torch.float32, device=p.device),
                torch.arange(ww, dtype=torch.float32, device=p.device),
                indexing="ij")
            dec = torch.stack([dec[..., 0] + gx, dec[..., 1] + gy,
                               dec[..., 2] * sa[:, None, None, 0],
                               dec[..., 3] * sa[:, None, None, 1]], dim=-1)
        cx, cy, w_, h_ = (dec * scale).unbind(-1)        # pixels
        boxes = torch.stack([cx - w_ / 2, cy - h_ / 2,
                             cx + w_ / 2, cy + h_ / 2], dim=-1)
        b = boxes.shape[0]
        all_boxes.append(boxes.reshape(b, -1, 4))
        all_scores.append(torch.sigmoid(out.obj.float()[..., 0])
                          .reshape(b, -1))
    return torch.cat(all_boxes, dim=1), torch.cat(all_scores, dim=1)


_TOPK_CHUNK = 16384


def _sorted_top(x: torch.Tensor, k: int):
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _topk_wide(logits: torch.Tensor, k: int):
    """The first k of one stable descending sort of ``logits`` (B, n) ->
    (values, indices), taken in two stages where n is wide.

    The chunking was a workaround for the TPU's ``top_k``, slow at
    DySOEM-1280 widths (n about 1.6 M); on the card this stays a plain
    function that no detector path calls. Past 4 chunks of ``_TOPK_CHUNK``
    (with k at most one chunk) each chunk keeps its first k by a stable
    sort, and a stable sort of the survivors, laid out in chunk order,
    picks the k. Values and indices, ties included, are then exactly the
    single stable sort's: an element among the global first k has fewer
    than k elements before it in that order, so fewer in its own chunk;
    and among equal values the survivors stand in ascending index order,
    which the second stable sort keeps. (The JAX function found its tie
    order only empirically and falls back to one sort beyond the shapes it
    tried; here the order is exact at any width.)
    """
    b, n = logits.shape
    if n < 4 * _TOPK_CHUNK or k > _TOPK_CHUNK:
        return _sorted_top(logits, k)
    m = -(-n // _TOPK_CHUNK)
    xp = F.pad(logits, (0, m * _TOPK_CHUNK - n), value=-torch.inf)
    v1, i1 = _sorted_top(xp.reshape(b, m, _TOPK_CHUNK), k)
    base = torch.arange(m, device=logits.device)[None, :, None] * _TOPK_CHUNK
    g1 = (base + i1).reshape(b, m * k)
    v2, i2 = _sorted_top(v1.reshape(b, m * k), k)
    return v2, torch.gather(g1, 1, i2)


def decode_topk_heads(outs, anchors, head_scales: Sequence[int],
                      pre_nms_topk: int, return_logits: bool = False):
    """Per head, the ``pre_nms_topk`` candidates of the highest objectness
    logit (``_topk_wide``), decoded: the union holds the global top-k.

    -> boxes (B, sum_h k_h, 4) xyxy f32 and scores (B, sum_h k_h) f32, head
    by head; with ``return_logits`` also the kept logits in their native
    dtype, the key a second top-k must sort on to agree with
    ``decode_topk_global`` (the f32 sigmoid saturates to 1.0 above a logit
    of about 16.6).
    """
    all_b, all_s, all_l = [], [], []
    for h, out in enumerate(outs):
        scale = head_scales[h]
        b, a, hh, ww, _ = out.obj.shape
        n = a * hh * ww
        k = min(pre_nms_topk, n)
        logits = out.obj.reshape(b, n)
        _, top_i = _topk_wide(logits, k)
        top_l = torch.gather(logits, 1, top_i)
        sel = torch.gather(out.bbox.reshape(b, n, 4), 1,
                           top_i[..., None].expand(b, k, 4))
        rem = top_i % (hh * ww)
        ai = top_i // (hh * ww)
        anc = torch.tensor(np.asarray(anchors[h], np.float32),
                           device=logits.device)          # (A, 2) pixels
        all_b.append(_candidate_boxes(sel, (rem % ww).float(),
                                      (rem // ww).float(), scale,
                                      anc[ai, 0], anc[ai, 1]))
        all_s.append(torch.sigmoid(top_l.float()))
        all_l.append(top_l)
    out3 = (torch.cat(all_b, dim=1), torch.cat(all_s, dim=1),
            torch.cat(all_l, dim=1))
    return out3 if return_logits else out3[:2]


def decode_topk_global(outs, anchors, head_scales: Sequence[int],
                       pre_nms_topk: int):
    """One top-k over the concatenated objectness logits of all heads, then
    the decode of the survivors only.

    The sort is on the logits in their native dtype, stable and descending,
    so ties break by the lowest concatenated index as in the reference (and
    never on the f32 sigmoid, which saturates to 1.0 above a logit of about
    16.6). -> boxes (B, k, 4) xyxy f32, scores (B, k) f32, by descending
    score.
    """
    b = outs[0].obj.shape[0]
    anc = np.asarray(anchors, np.float32)      # (heads, A, 2) pixels
    n_a = anc.shape[1]
    tab = _head_tables(outs[0].obj.device,
                       tuple(tuple(o.obj.shape[1:4]) for o in outs),
                       tuple(map(tuple, anc.reshape(-1, 2).tolist())),
                       tuple(float(s) for s in head_scales))
    k = min(pre_nms_topk, tab["n"])

    logits = torch.cat([o.obj.reshape(b, -1) for o in outs], dim=1)
    bbox = torch.cat([o.bbox.reshape(b, -1, 4) for o in outs], dim=1)
    top_l, top_i = torch.sort(logits, dim=1, descending=True, stable=True)
    top_l, top_i = top_l[:, :k], top_i[:, :k]

    # each candidate's head, then its anchor and grid cell within the head
    hid = (top_i[..., None] >= tab["bounds"]).sum(-1)
    rel = top_i - tab["off"][hid]
    hw = tab["hw"][hid]
    ww = tab["ww"][hid]
    ai = rel // hw
    rem = rel % hw
    gx = (rem % ww).float()
    gy = (rem // ww).float()
    scale = tab["scale"][hid]
    aw = tab["anchors"][hid * n_a + ai, 0]
    ah = tab["anchors"][hid * n_a + ai, 1]

    sel = torch.gather(bbox, 1, top_i[..., None].expand(b, k, 4))
    return (_candidate_boxes(sel, gx, gy, scale, aw, ah),
            torch.sigmoid(top_l.float()))


def select_detections(boxes: torch.Tensor, scores: torch.Tensor,
                      score_threshold: float, nms_iou: float, max_det: int,
                      alive_fn=nms_alive) -> Detections:
    """Threshold, greedy NMS and the fixed-shape result of score-sorted
    candidates. ``alive_fn`` is the NMS survivor mask (see batched_nms)."""
    # the masked suffix keeps the descending order NMS consumes
    scores = torch.where(scores >= score_threshold, scores, -torch.inf)
    keep_idx, _, _ = batched_nms(boxes, scores, nms_iou, max_det, alive_fn)
    valid = keep_idx >= 0
    safe = keep_idx.clamp_min(0)
    out_b = torch.gather(boxes, 1, safe[..., None].expand(*safe.shape, 4))
    out_s = torch.gather(scores, 1, safe)
    return Detections(boxes=torch.where(valid[..., None], out_b, 0.0),
                      scores=torch.where(valid, out_s, 0.0), valid=valid)


class Detector(nn.Module):
    """The detector as one module holding ``model``: ``forward(images)``, or
    with ``dual`` ``forward(rgb, ir)``, takes frames on the model's device
    and returns (boxes, scores, valid) as ``Detections`` holds them.
    ``make_detector`` calls it; ``export.export_detector`` traces it, so
    the model's weights travel in the artifact."""

    def __init__(self, model, hparams, input_size: int,
                 score_threshold: float = 0.001, nms_iou: float = 0.5,
                 pre_nms_topk: int = 512, max_det: int = 300,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 dual: bool = False):
        super().__init__()
        self.model = model
        self.anchors = np.asarray(hparams.anchors, np.float32)
        self.input_size = input_size
        self.score_threshold = score_threshold
        self.nms_iou = nms_iou
        self.pre_nms_topk = pre_nms_topk
        self.max_det = max_det
        self.compute_dtype = compute_dtype
        self.dual = dual
        self.stem = detector_stem_fast_path(model)
        self.sp = None   # (group, index, n) of the spatial detect

    def heads(self, x) -> list:
        """The model's heads of frames x (B, H, W, 3); under ``sp`` from the
        rank's band of their rows, gathered over the group."""
        stem = self.stem
        if self.sp is None:
            return stem.tail(stem.stem(x)) if stem is not None \
                else self.model(x)
        from .parallel import gather_rows, model_stride, row_band, sp_rows
        group, index, n = self.sp
        height = x.shape[1]
        band = row_band(index, n, height, model_stride(self.model))
        with sp_rows(self.model, group):
            if stem is not None:
                top = STEM_HALO[0] if band.start else 0
                bottom = STEM_HALO[1] if band.stop < height else 0
                outs = stem.tail(stem.rows(
                    x[:, band.start - top:band.stop + bottom], top, bottom,
                    group))
            else:
                outs = self.model(x[:, band.start:band.stop])
        return [DetectionResults(bbox=gather_rows(o.bbox, group, dim=2),
                                 obj=gather_rows(o.obj, group, dim=2))
                for o in outs]

    def post(self, outs) -> Detections:
        """The heads -> Detections: the global top-k and decode, then the
        threshold and NMS (kernel C on the card)."""
        scales = [self.input_size // o.obj.shape[3] for o in outs]
        boxes, scores = decode_topk_global(outs, self.anchors, scales,
                                           self.pre_nms_topk)
        return select_detections(boxes, scores, self.score_threshold,
                                 self.nms_iou, self.max_det)

    def body(self, x) -> Detections:
        """x: frames at the detector's grid, raw uint8 (stem kernels only)
        or preprocessed."""
        return self.post(self.heads(x))

    def prepare(self, x: torch.Tensor, ir: torch.Tensor | None = None):
        """The frames ``forward`` takes -> what ``body`` takes: uint8 frames
        at the detector's size stay as they are for the stem kernels, any
        other frames are preprocessed."""
        size, dtype = self.input_size, self.compute_dtype
        if self.dual:
            return preprocess_dual(x, ir, size, dtype)
        if self.stem is not None and x.dtype == torch.uint8 \
                and tuple(x.shape[1:3]) == (size, size):
            return x
        return preprocess(x, size, dtype)

    def forward(self, x: torch.Tensor, ir: torch.Tensor | None = None):
        return tuple(self.body(self.prepare(x, ir)))


def _on_rows(detect, model, mesh):
    """``detect(*batches)`` (each (B, ...), the detections input-major,
    n_in * B rows of K slots) as the sharded detect: this rank detects its
    rows of every batch (its block over data x fsdp x ep) and every rank's
    detections are gathered in the global order (one rank of each ``sp``
    group: its ranks hold the same rows). A rank without rows detects
    nothing and takes part in the gather; K (max_det, or fewer where fewer
    candidates go into the NMS) then comes from the other ranks, in one
    more all-reduce."""
    import torch.distributed as dist
    from .parallel import (all_gather_rows, batch_group, batch_group_size,
                           batch_index, coordinate, row_block)
    world = mesh.size()
    firsts = [r for r in range(world) if coordinate(mesh, r)[2] == 0]

    @torch.inference_mode()
    def run(*batches) -> Detections:
        b, n_in = len(batches[0]), len(batches)
        groups = batch_group_size(mesh)
        blocks = [row_block(i, groups, b) for i in range(groups)]
        mine = blocks[batch_index(mesh)]
        device = next(model.parameters()).device
        if len(mine):
            det = detect(*(x[mine.start:mine.stop] for x in batches))
            packed = torch.cat([det.boxes.float(),
                                det.scores.float()[..., None],
                                det.valid.float()[..., None]], dim=-1)
        else:
            packed = torch.zeros((0, 0, 6), device=device)
        k = packed.shape[1]
        if not all(len(r) for r in blocks):
            slots = torch.tensor([k], device=device)
            dist.all_reduce(slots, dist.ReduceOp.MAX,
                            group=batch_group(mesh))
            k = int(slots)
        packed = packed.reshape(n_in, len(mine), k, 6).transpose(0, 1)
        counts = [len(blocks[batch_index(mesh, r)]) for r in range(world)]
        full = all_gather_rows(packed, counts, batch_group(mesh))
        if len(firsts) < world:   # one rank of each sp group
            at = np.cumsum([0] + counts)
            full = torch.cat([full[at[r]:at[r + 1]] for r in firsts])
        full = full.transpose(0, 1).reshape(n_in * b, k, 6)
        return Detections(boxes=full[..., :4], scores=full[..., 4],
                          valid=full[..., 5] > 0)

    return run


def _check_full_weights(model) -> None:
    if any(getattr(p, "ep_slice", None) is not None
           for p in model.parameters()):
        raise ValueError("the detector takes a model with its full expert "
                         "weights; this one holds ep slices (gather them "
                         "into a plain copy with parallel.copy_full_weights)")


def make_detector(model, hparams, input_size: int,
                  score_threshold: float = 0.001, nms_iou: float = 0.5,
                  pre_nms_topk: int = 512, max_det: int = 300,
                  compute_dtype: torch.dtype = torch.bfloat16,
                  dual: bool = False, mesh=None, spatial: bool = False):
    """``detect(images) -> Detections`` for NHWC frames (B, H, W, 3), uint8
    at any resolution or float in [0, 1]. The weights are ``model``'s own,
    read at every call; frames are moved to the model's device.

    ``dual``: build ``detect(rgb, ir)`` instead. Both batches of B frames,
    each at its own resolution, go through ``preprocess_dual`` and are
    detected as one modality-major batch of 2B frames.

    When the model starts with the DyConv(32,3,1), DyConv(64,3,2) stem, it
    runs through the stem kernels (``detector_stem_fast_path``), and uint8
    frames already at ``input_size`` skip ``preprocess``. For any other
    model, frames already at ``input_size`` are only normalized: the resize
    of ``preprocess`` does nothing at the size it is asked for.

    ``mesh``: the sharded detect (see the module docstring); every rank
    passes the global batch (or batches) and gets the global detections.
    ``spatial``: each rank of the mesh's ``sp`` axis runs its band of the
    rows (see the module docstring); it needs a ``mesh`` with that axis,
    and ``input_size`` a multiple of sp x the model's largest stride.
    """
    det = Detector(model, hparams, input_size, score_threshold, nms_iou,
                   pre_nms_topk, max_det, compute_dtype, dual)
    if spatial:
        from .parallel import coordinate, model_stride, row_band, sp_group
        if mesh is None:
            raise ValueError("spatial=True requires mesh")
        if "sp" not in (mesh.mesh_dim_names or ()):
            raise ValueError("spatial=True needs an 'sp' mesh axis (mesh "
                             f"has {mesh.mesh_dim_names}); build the mesh "
                             "with parallel.make_mesh(..., n_sp=...)")
        n = mesh["sp"].size()
        row_band(0, n, input_size, model_stride(model))
        if n > 1:
            det.sp = (sp_group(mesh), coordinate(mesh)[2], n)
    if mesh is not None:
        _check_full_weights(model)

    @torch.inference_mode()
    def detect(images) -> Detections:
        device = next(model.parameters()).device
        return Detections(*det(torch.as_tensor(images, device=device)))

    @torch.inference_mode()
    def detect_dual(rgb, ir) -> Detections:
        device = next(model.parameters()).device
        return Detections(*det(torch.as_tensor(rgb, device=device),
                               torch.as_tensor(ir, device=device)))

    fn = detect_dual if dual else detect
    return fn if mesh is None else _on_rows(fn, model, mesh)


def rtm_candidates(outs, input_size: int, det_scales: Sequence[int]):
    """An RTMUAVDet's decoded heads -> boxes (B, N, 4) xyxy pixels and
    scores (B, N), head-major: each head's cxcywh grid units times its
    stride ``input_size // det_scales[h]``."""
    boxes, scores = [], []
    for h, o in enumerate(outs):
        b = o.bbox.shape[0]
        bb = o.bbox.reshape(b, -1, 4) * (input_size // det_scales[h])
        boxes.append(torch.stack(
            [bb[..., 0] - bb[..., 2] / 2, bb[..., 1] - bb[..., 3] / 2,
             bb[..., 0] + bb[..., 2] / 2, bb[..., 1] + bb[..., 3] / 2],
            dim=-1))
        scores.append(o.obj.reshape(b, -1))
    return torch.cat(boxes, dim=1), torch.cat(scores, dim=1)


def make_rtm_detector(model, input_size: int, det_scales: Sequence[int],
                      pre_nms_topk: int = 512, nms_iou: float = 0.5,
                      max_det: int = 300,
                      compute_dtype: torch.dtype | None = None,
                      alive_fn=nms_alive, mesh=None, spatial: bool = False):
    """``detect(images) -> Detections`` for an RTMUAVDet in eval mode: the
    unfolded detect of the JAX package's cfg4 (``bench.py:158-186``) with
    the boxes kept beside the scores. NHWC frames (B, H, W, 3), uint8 or
    float in [0, 1], are moved to the model's device; no score threshold
    (the scores are the heads' probabilities); invalid slots are zero.
    ``compute_dtype`` None is the model's own; ``alive_fn`` is the NMS
    survivor mask (``nms_alive_plain`` holds the kernel against the plain
    path); ``mesh`` the sharded detect, as ``make_detector``'s. There is no
    RTMUAVDet under ``sp`` (nor in the JAX package): ``spatial`` raises."""
    if spatial:
        raise ValueError("make_rtm_detector has no spatial (sp) detect: the "
                         "JAX package serves RTMUAVDet only whole (bench.py's "
                         "cfg4); pass spatial=False and shard the batch")

    @torch.inference_mode()
    def detect(images) -> Detections:
        param = next(model.parameters())
        x = preprocess(torch.as_tensor(images, device=param.device),
                       input_size, compute_dtype or param.dtype)
        boxes, scores = rtm_candidates(model(x), input_size, det_scales)
        k = min(pre_nms_topk, scores.shape[1])
        top_s, top_i = _topk_wide(scores, k)
        top_b = torch.gather(boxes, 1, top_i[..., None].expand(*top_i.shape,
                                                               4))
        keep, _, _ = batched_nms(top_b, top_s, nms_iou, max_det, alive_fn)
        valid = keep >= 0
        safe = keep.clamp_min(0)
        out_b = torch.gather(top_b, 1, safe[..., None].expand(*safe.shape,
                                                              4))
        return Detections(
            boxes=torch.where(valid[..., None], out_b, 0.0),
            scores=torch.where(valid, torch.gather(top_s, 1, safe), 0.0),
            valid=valid)

    return detect if mesh is None else _on_rows(detect, model, mesh)
