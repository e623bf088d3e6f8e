#!/usr/bin/env python3
"""DySOEM_SimFPN's device time by section at cfg3, beside each section's floor.

Port of ``scripts/cfg3_section_probe.py`` and of its twin for the JAX
package's shipped program, ``scripts/cfg3_dyconv_section_probe.py``: the
port has one DySOEM_SimFPN program, unfolded (the TPU's folded input stem
and row-folded neck are not ported), so this one script covers both.
Full-width DySOEM_SimFPN (``models.registry.DYSOEM``) with seeded random
weights, bf16, batch 32 of uint8 frames at 1280 px: the infrared cell
cfg3. The sections are the JAX table's:

  front      ``preprocess`` (/255 to bf16) and the 1x1 input stem
  soem_0..2  each SOEM: one launch of kernel D with its ``emit_gap`` sums,
             and the ``pooled_from_sums`` that feeds the next SOEM's
             attention (``DySOEM_SimFPN.soem_step``)
  neck+head  the SimplifiedFPN and the YOLOHead
  post       ``Detector.post``: the global top-k and decode, the threshold
             and the NMS (kernel C)

One sectioned call runs the model's own steps in ``forward``'s order
(``front``, ``soem_step`` per SOEM, ``neck_head``), then
``inference.Detector.post``, and is timed as ``section_probe.py`` times
DyYOLO's: a CUDA event after each section, ``--iters`` calls back to back,
medians, the plain ``detect`` back to back beside them, the heads and
Detections held bitwise against ``Detector.heads`` and ``detect``, the
launches counted. The floors are ``roofline_table.soem_section_floors``
(post has none). On the card unless ``--device cpu`` is given.

Usage: python3 -m uavdet_tpu_torch.scripts.cfg3_section_probe [--batch 32]
       [--input 1280] [--iters 10] [--warmup 3] [--seed 0] [--device cpu]
"""

from .roofline_table import soem_section_floors
from .section_probe import (device_of, measure, no_mark, parse_args,
                            print_report, uint8_frames)


def sectioned_dysoem(det):
    """-> (names, run): ``run(frames, mark)`` is ``det``'s detect (an
    ``inference.Detector`` of a DySOEM_SimFPN) cut into ``names``, calling
    ``mark(name)`` after each; it returns (heads, Detections)."""
    model = det.model
    soems = [f"soem_{i}" for i in range(model.n_soem)]

    def run(frames, mark=no_mark):
        x = model.front(det.prepare(frames))
        mark("front")
        pooled, feats = None, []
        for i, name in enumerate(soems):
            x, pooled = model.soem_step(i, x, pooled)
            feats.append(x)
            mark(name)
        heads = model.neck_head(feats)
        mark("neck+head")
        dets = det.post(heads)
        mark("post")
        return heads, dets

    return ["front", *soems, "neck+head", "post"], run


def main(argv=None, model=None) -> dict:
    """Prints the section table; -> the report. ``model``: a DySOEM_SimFPN
    to probe in place of a freshly seeded one (on ``--device``)."""
    from ..inference import Detector, make_detector
    from ..models.registry import DYSOEM, serving_dtype
    from ..utils.seeding import seeded_model
    args = parse_args(argv, 32, 1280, 10)
    device = device_of(args.device)
    dtype = serving_dtype(device)
    if model is None:
        model = seeded_model("DySOEM_SimFPN", DYSOEM, args.seed, device)
    kw = dict(compute_dtype=dtype)
    det = Detector(model, DYSOEM, args.input, **kw)
    detect = make_detector(model, DYSOEM, args.input, **kw)
    names, run = sectioned_dysoem(det)
    frames = uint8_frames(args.seed, (args.batch, args.input, args.input, 3),
                          device)
    floors = soem_section_floors(args.batch, args.input)
    report = measure(det, detect, names, run, frames, floors, args.iters,
                     args.warmup)
    report.update(model="DySOEM_SimFPN", batch=args.batch, input=args.input)
    print_report(f"DySOEM_SimFPN batch {args.batch} at {args.input} px, "
                 f"{dtype}", report, device)
    return report


if __name__ == "__main__":
    main()
