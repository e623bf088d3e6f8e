"""Frames -> the configuration's detector entry -> (boxes, scores, valid).

The mix (``traffic/<mix>.json``): ``batch`` frames of ``size`` pixels a
call, made by ``traffic.detect_inputs`` from ``frames``' parameters;
``distinct`` batches, called in turn; ``loop`` "closed" (calls issued back
to back, the host free to run ahead) or "one_in_flight" (each call's
answer copied to the host before the next call, its latency timed);
``warmup_calls`` more calls in set-up after one of each batch;
``check_calls`` answers of the window kept for the check, whose reference
runs ``reference_block`` frames at a time; ``issue_calls``,
``profile_calls`` and ``label_calls`` for the traced run's slices.
"""

import time

import torch

from perfbench import compare, traffic as traffic_gen
from perfbench.drive import (Reservoir, entry, reference_model,
                             reference_precision, sync)
from perfbench.reference import detect as ref_detect
from perfbench.weights import seeded_state


class Cell:
    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.dtype = getattr(torch, config["dtype"])
        self.calls = 0

    def inputs(self):
        """The weights and frames of the seed."""
        spec = reference_model(self.config, "meta")
        self.state = seeded_state(spec, self.seed, self.device, self.dtype)
        self.frames = traffic_gen.detect_inputs(self.traffic, self.seed,
                                                self.device)

    def setup(self):
        self.inputs()
        self.detect = entry(self.config["entry"]).build(
            self.config, self.state, self.device, self.traffic["size"])
        for i in range(len(self.frames) + self.traffic["warmup_calls"]):
            self.call(i)
        sync(self.device)

    def call(self, i: int):
        out = self.detect(self.frames[i % len(self.frames)])
        if self.traffic["loop"] == "one_in_flight":
            out = tuple(t.cpu() for t in out)
        return out

    def issue(self):
        self.detect(self.frames[self.calls % len(self.frames)])
        self.calls += 1

    def run_one(self):
        self.call(self.calls)
        self.calls += 1

    def window(self, seconds: float) -> dict:
        """Drives the mix for ``seconds`` -> its readings: calls
        (``attempted``), ``wall_s``, ``rate`` (frames of every call / wall;
        the window starts at a synchronize and ends at one after the last
        call) and, one in flight, every call's ``latencies_s``."""
        keep = Reservoir(self.traffic["check_calls"], self.seed)
        latencies = []
        one = self.traffic["loop"] == "one_in_flight"
        sync(self.device)
        t0 = time.perf_counter()
        end, n = t0 + seconds, 0
        while True:
            ts = time.perf_counter()
            out = self.call(n)
            if one:
                latencies.append(time.perf_counter() - ts)
            keep.offer(n, out)
            n += 1
            if time.perf_counter() >= end:
                break
        sync(self.device)
        wall = time.perf_counter() - t0
        self.kept, self.calls = keep.items, n
        out = {"attempted": n, "wall_s": wall,
               "rate": n * self.traffic["batch"] / wall}
        if one:
            out["latencies_s"] = latencies
        return out

    def free(self):
        del self.detect
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_outputs(self, index: int, quant=None, nms=False):
        """The reference on distinct batch ``index`` -> its candidates
        (``reference.detect.candidates``) and, with ``nms``, its per-frame
        detections."""
        d = self.config["detector"]
        frames = self.frames[index]
        block = self.traffic["reference_block"]
        parts = []
        with torch.no_grad():
            for s in range(0, len(frames), block):
                outs = self.ref(frames[s:s + block].float() / 255.0, quant)
                parts.append(ref_detect.candidates(
                    outs, self.config["hparams"]["anchors"],
                    self.traffic["size"], d["pre_nms_topk"]))
        cand = dict(parts[0])
        for key in ("boxes", "logits", "top"):
            cand[key] = torch.cat([p[key] for p in parts])
        if not nms:
            return cand, None
        rows = torch.arange(len(frames), device=cand["top"].device)[:, None]
        return cand, ref_detect.detections(
            cand["boxes"][rows, cand["top"]], cand["logits"][rows, cand["top"]],
            d["score_threshold"], d["nms_iou"], d["max_det"])

    def load_reference(self):
        self.ref = reference_model(self.config, self.device)
        self.ref.load_state_dict(self.state)
        self.ref.eval()

    @reference_precision()
    def check(self) -> list:
        """-> per compared call its numbers (see ``compare``)."""
        self.load_reference()
        d = self.config["detector"]
        refs, parts = {}, []
        for i, out in sorted(self.kept, key=lambda kv: kv[0]):
            index = i % len(self.frames)
            if index not in refs:
                refs[index] = self.reference_outputs(index)
            prog = tuple(t.to(self.device) for t in out)
            parts.append(compare.detection_numbers(prog, refs[index][0], d))
        return parts

    @reference_precision()
    def control(self) -> list:
        """The reference in float8 in the program's place, judged as the
        program is, on every distinct batch."""
        self.load_reference()
        d = self.config["detector"]
        parts = []
        for index in range(len(self.frames)):
            cands, _ = self.reference_outputs(index)
            _, control = self.reference_outputs(index, "fp8", nms=True)
            parts.append(compare.detection_numbers(
                padded(control, d["max_det"]), cands, d))
        return parts


def padded(dets, max_det: int):
    """Per-frame (boxes, scores) -> the program's fixed-shape (boxes,
    scores, valid)."""
    b = len(dets)
    device = dets[0][0].device
    boxes = torch.zeros((b, max_det, 4), device=device)
    scores = torch.zeros((b, max_det), device=device)
    valid = torch.zeros((b, max_det), dtype=torch.bool, device=device)
    for i, (bx, sc) in enumerate(dets):
        boxes[i, :len(bx)], scores[i, :len(sc)] = bx, sc
        valid[i, :len(bx)] = True
    return boxes, scores, valid
