#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``uavdet_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It needs one CUDA device and ``nvcc`` (CUDA_HOME), and imports neither JAX
nor PyYAML. The phases, in order:

  0. the card: name and power limit (nvidia-smi); TF32 off, so that the
     plain versions' f32 convolutions stay f32;
  1. builds the seven CUDA kernels from ``uavdet_tpu_torch/csrc`` (nvcc,
     sm_90a, one nvcc per source, all at once);
  2. kernel A (stem L1) against its plain version, on uint8 frames
     (16, 640, 640, 3), on bf16 frames of an odd shape, and on uint8 and
     bf16 frames at the shapes of ``ops.stem.L1_EDGE_SHAPES`` (sizes that
     straddle its 16 x 64 block tile and a warp's 16-pixel fragment):
     output and channel sums, and two launches' sums bitwise equal;
  3. kernel B (stem L2) against its plain version at (16, 640, 640, 32) and
     at the shapes of ``ops.stem.L2_EDGE_SHAPES`` (odd H and W, sizes that
     straddle its 16 x 16 output tile);
  4. the NMS kernel against its plain version at (16, 512) boxes with
     duplicates, equal scores, zero-area boxes and -inf padding, and at the
     cases of ``ops.nms.NMS_EDGE_CASES`` (1 to 4096 boxes, sizes off the
     64-rank mask word and the 8 blocks of a cluster, the path with the mask
     in device memory past 1024 boxes, all boxes identical, no two
     overlapping): bitwise;
  5. kernel D (dyconv) against its plain version: the shapes of
     ``ops.dyconv.EDGE_SHAPES`` (sizes that straddle its 16 x 16 pixel
     tile, its chunks of 16 input channels and its N tiles of 64 and 128
     output channels; ``fold_out`` where H is even), then the inputs the
     three SOEM sites of full-width DySOEM_SimFPN get from a batch of 32
     1280 px frames: the first 4 images of each with and without
     ``emit_gap`` and, at the first site, ``fold_out``; then the launch
     over all 32 images as the main path makes it, held against the plain
     version 4 images at a time (the plain version's f32 copies bound its
     batch). Everywhere ``emit_gap`` leaves the output bitwise as it is,
     and a second run gives bitwise the same output and sums;
  5e. kernel E (the fused stem) against its plain version, and bitwise
     against kernel B of kernel A's output (it runs kernel A's first layer
     and kernel B's tile code), on the uint8 frames (16, 640, 640, 3) and
     on bf16 frames of an odd shape; then its path, the public op, 3 calls;
  5f. kernel F (kernel B's stage ladder): the ``full`` stage bitwise equal
     to kernel B's output; then its path, the ladder's command-line entry
     ``uavdet_tpu_torch.scripts.l2_ablate``, which prints every stage's
     time;
  5g. kernel G (the fused post-stem block) against its plain version at
     (16, 320, 320, 64) with the weights folded from the full-width DyYOLO
     (packed once, and as the (O, K + 1) matrices: bitwise the same), at an
     odd shape, at the shapes of ``ops.block.BLOCK_EDGE_SHAPES`` (sizes off
     its 8 x 8 output tile, one pixel, H = 2, W = 1, a part-full last round
     of its persistent grid, odd batches), and on a small input with large
     biases, where every output depends on the zero padding of the two
     inner activations; each twice, bitwise equal; then its path,
     ``uavdet_tpu_torch.scripts.block_ablate``;
  6. main path 1: full-width DyYOLO (conf/model/dy-yolo.yaml widths), bf16,
     seeded random weights, answers 3 requests of 16 uint8 640x640 frames
     through ``make_detector``; checks the results and the launch counts
     (stem kernels and NMS once per request, dyconv never); then runs the
     same batch with the plain versions in place of the kernels and
     compares;
  7. main path 2: full-width DySOEM_SimFPN (conf/model/dy-soem_fpn.yaml),
     bf16, seeded random weights, answers 3 requests of 32 uint8 1280x1280
     frames through ``make_detector``; checks the results and the launch
     counts (dyconv three times and NMS once per request, the stem kernels
     never); then runs the first 8 frames with the plain versions in place
     of the kernels and compares;
  7b. main path 3: full-width BaselineModel (conf/model/baseline.yaml),
     bf16, seeded random weights, answers 3 requests of 1 uint8 640x640
     frame (NMS once per request, no other kernel); compared with the plain
     path;
  7c. main path 4: the dual-stream detector on full-width DyYOLO: 3
     requests of 8 RGB (1080x1920) + 8 infrared (512x640) uint8 frames
     through ``make_detector(..., dual=True)`` (stem kernels and NMS once
     per request); compared with the plain path;
  7d. DyYOLO with ``pre_nms_topk=4096`` (3 requests of 16 frames; the NMS
     kernel's path with the mask in device memory), compared with the
     plain path;
  7e. DySOEM_SimFPN in float32 (batch 2, 256 px, eval mode): its SOEMs
     take the grouped conv (no kernel claims f32), against the same
     model's detections on the CPU;
  8. times, with CUDA events, medians after warm-up: the four detectors per
     batch, and each kernel at its main-path shapes beside its plain
     version and beside one bf16 ``F.conv2d(groups=B)`` call that computes
     the same function (``library_ms``; the port never calls it; for kernel
     E two such calls, for kernel G three shared-weight bf16 convs with
     their leaky and add), with the
     least time the card could take (``bound_ms``: bytes over 3.35 TB/s or
     operations over the peak rate of their type, whichever is larger);
     kernel D also on all-zero operands (what the power limit costs it);
     every kernel also as the mean of back-to-back launches
     (``back_to_back_ms``: one launch between two events also counts the
     host's time to launch it, which is most of a 30 us kernel's reading);
     the NMS kernel also at (1, 512) and (16, 4096), its two phases by the
     card's global timer, and an empty launch of its grid; kernel G with
     the weights packed once, its time alone by the profiler, and the eager
     tail's two layers it replaces;
  9. a ``torch.profiler`` window of each detector: device time by kernel.

No detector path may launch kernel E, F or G: their paths are the op and
the two command-line entries, as in the JAX package.

Any failed phase makes it exit with 1 and print no result. Otherwise the
last three lines are one JSON object of the kernels, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.
"""

import json
import sys
import time
import traceback

import numpy as np

BATCH, SIZE, REQUESTS = 16, 640, 3
DUAL_BATCH, RGB_HW, IR_HW = 8, (1080, 1920), (512, 640)   # per modality
LADDER_ITERS = 10                    # timed launches per stage of a ladder
SOEM_BATCH, SOEM_SIZE = 32, 1280     # DySOEM_SimFPN's serving shape
SOEM_CHECK_BATCH = 4                 # images per call of kernel D's plain version
SOEM_PLAIN_FRAMES = 8                # frames of main path 2 run through the plain versions
ITERS, WARMUP = 20, 3
SOEM_ITERS, SOEM_WARMUP = 5, 2       # the DySOEM detector and kernel D per site
PLAIN_ITERS, PLAIN_WARMUP = 2, 1     # kernel D's f32 plain version at batch 32
SEED = 0
NMS_N = 512
NMS_LARGE_N = 4096                   # the NMS kernel's path with the mask in device memory
F32_BATCH, F32_SIZE = 2, 256         # the float32 DySOEM_SimFPN, card against CPU
# published peaks of one H100 SXM: bytes/s of device memory, dense bf16 on the
# tensor cores, f32 outside them
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
# bf16 output of an f32 sum: the kernels and their plain versions add the
# same bf16 products in another order, which can move a result across a
# bf16 rounding boundary (one ulp, 2^-8 relative), rarely further
RTOL, ATOL = 1.6e-2, 1e-2
# detections of the kernel path against the plain path: one flipped bf16 ulp
# in a kernel's output is followed by bf16 roundings in every later layer, so
# the heads' logits differ by a few hundredths (printed per head). A logit
# error d moves a score s = sigmoid(logit) by s (1 - s) d, so the limit on a
# score difference is LOGIT_TOL * s (1 - s) at the plain path's top score
# (0.5 where that is higher): about 2.7e-3 for DyYOLO's 0.028 and 2.4e-2 for
# DySOEM_SimFPN's 0.4 to 0.5. Runs on an H100 measured differences that
# correspond to 0.03 to 0.045 in the logit on both models; a wrong tap,
# channel order or suppression moves logits by whole units.
LOGIT_TOL = 0.1
# a float32 model on the card against the same model on the CPU (TF32 off):
# the same operations summed in another order, errors of a few f32 ulps
# carried through the network
F32_LOGIT_TOL = 1e-3

KERNELS = {
    "stem_l1": ("uavdet_tpu_torch/csrc/stem_l1.cu",
                "uavdet_tpu/ops/pallas_stem_split.py:62"),
    "stem_l2": ("uavdet_tpu_torch/csrc/stem_l2.cu",
                "uavdet_tpu/ops/pallas_stem_split.py:256"),
    "nms": ("uavdet_tpu_torch/csrc/nms.cu", "uavdet_tpu/ops/pallas_nms.py:28"),
    "dyconv": ("uavdet_tpu_torch/csrc/dyconv.cu",
               "uavdet_tpu/ops/pallas_dyconv.py:54"),
    "stem_fused": ("uavdet_tpu_torch/csrc/stem_fused.cu",
                   "uavdet_tpu/ops/pallas_stem.py:37"),
    "stem_l2_stage": ("uavdet_tpu_torch/csrc/stem_l2.cu",
                      "scripts/l2_ablate.py:27"),
    "post_stem_block": ("uavdet_tpu_torch/csrc/post_stem_block.cu",
                        "scripts/block_ablate.py:44"),
}
# launches per request on each main path; a kernel not named is launched 0
# times there
EXPECTED_LAUNCHES = {
    "DyYOLO": {"stem_l1": 1, "stem_l2": 1, "nms": 1},
    "DySOEM_SimFPN": {"nms": 1, "dyconv": 3},
    "baseline": {"nms": 1},
    "DyYOLO dual": {"stem_l1": 1, "stem_l2": 1, "nms": 1},
    "DyYOLO pre_nms_topk 4096": {"stem_l1": 1, "stem_l2": 1, "nms": 1},
    "DySOEM_SimFPN float32": {"nms": 1},
    "stem_fused op": {"stem_fused": 1},
    # one run of a ladder's entry point: every stage, warm-up included
    "l2_ablate": {"stem_l2_stage": 5 * (LADDER_ITERS + 3)},
    "block_ablate": {"post_stem_block": 4 * (LADDER_ITERS + 3)},
}


class Smoke:
    def __init__(self):
        self.failures = []
        self.stats = {name: {"launches": 0, "launches_by_path": {}}
                      for name in KERNELS}

    def check(self, name: str, ok: bool, detail: str) -> None:
        print(f"{'PASS' if ok else 'FAIL'} {name}: {detail}", flush=True)
        if not ok:
            self.failures.append(name)

    def phase(self, name: str, fn, *args):
        print(f"== {name}", flush=True)
        try:
            return fn(*args)
        except Exception:   # record, report, and go on to the next phase
            traceback.print_exc()
            self.check(name, False, "raised")
            return None


def cuda_ms(fn, iters: int = ITERS, warmup: int = WARMUP) -> float:
    """Median device time of one call, by CUDA events, after warm-up."""
    from uavdet_tpu_torch.utils.timing import cuda_ms as timed
    return timed(fn, iters, warmup)


def back_to_back_ms(fn, iters: int = ITERS) -> float:
    """Mean device time of one call among ``iters`` launched back to back."""
    from uavdet_tpu_torch.utils.timing import back_to_back_ms as timed
    return timed(fn, iters, 1)


def kernel_row_ms(fn, key: str, iters: int):
    """Device time of one call's kernels whose name holds ``key``, by
    ``torch.profiler`` over ``iters`` calls after one warm-up: the kernel
    alone. None where the profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and key in e.key)
    return us / iters / 1e3 if us > 0 else None


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, n_ops: float, ops_per_s: float) -> dict:
    """The least time the card could take: every input byte read once and
    every output byte written once at the memory rate, or the operations at
    their peak rate, whichever is larger."""
    by_bytes, by_ops = n_bytes / HBM_BPS * 1e3, n_ops / ops_per_s * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": int(n_bytes), "operations": int(n_ops)}


def count_launches(smoke, kernels, path: str, requests: int) -> None:
    """Reads the launch counts of one main path's run and holds them against
    what that path launches per request."""
    counts = kernels.launch_counts()
    want = {k: EXPECTED_LAUNCHES[path].get(k, 0) * requests for k in counts}
    for name, n in counts.items():
        smoke.stats[name]["launches"] += n
        smoke.stats[name]["launches_by_path"][path] = n
    smoke.check(f"launches {path}", counts == want,
                f"{counts} for {requests} requests, expected {want}")


def check_requests(smoke, results, batch: int) -> None:
    import torch
    for i, d in enumerate(results):
        shapes = (tuple(d.boxes.shape), tuple(d.scores.shape),
                  tuple(d.valid.shape))
        finite = bool(torch.isfinite(d.boxes).all()
                      and torch.isfinite(d.scores).all())
        zero = bool((d.boxes[~d.valid] == 0).all()
                    and (d.scores[~d.valid] == 0).all())
        n_valid = d.valid.sum(1)
        smoke.check(f"request {i}", shapes == ((batch, 300, 4), (batch, 300),
                                               (batch, 300))
                    and finite and zero and bool((n_valid > 0).all()),
                    f"shapes {shapes} finite {finite} invalid-zero "
                    f"{zero} valid per image {n_valid.tolist()}")


def compare_heads(smoke, outs_k, outs_p) -> None:
    import torch
    for h, (ok_, op_) in enumerate(zip(outs_k, outs_p)):
        for field in ("obj", "bbox"):
            g = getattr(ok_, field).float()
            w = getattr(op_, field).float()
            corr = float(torch.corrcoef(torch.stack(
                [g.flatten(), w.flatten()]))[0, 1])
            err = float((g - w).abs().max())
            smoke.check(f"head {h} {field}", corr > 0.999,
                        f"max_abs_err {err:.4g} corr {corr:.6f}")


def compare_detections(smoke, d, plain, logit_tol=LOGIT_TOL,
                       name="detections vs plain path") -> None:
    import torch
    nk, np_ = d.valid.sum(1), plain.valid.sum(1)
    m = int(torch.minimum(nk, np_).min())
    score_err = float((d.scores[:, :m] - plain.scores[:, :m]).abs().max())
    count_gap = int((nk - np_).abs().max())
    top = float(plain.scores.max())
    s = min(top, 0.5)
    limit = logit_tol * s * (1.0 - s)
    smoke.check(name,
                score_err < limit and count_gap <= 0.05 * int(np_.max()),
                f"valid {nk.tolist()} vs {np_.tolist()}; max |score "
                f"diff| over the first {m} {score_err:.3g} (limit "
                f"{limit:.3g}: {logit_tol} in the logit at the top score "
                f"{top:.3g})")


def compare_bf16(smoke, name, got, want):
    """-> max abs error; checks the stated bf16 tolerance."""
    import torch
    g, w = got.float(), want.float()
    err = float((g - w).abs().max())
    equal = float((got == want).float().mean())
    ok = (got.shape == want.shape and bool(torch.isfinite(g).all())
          and torch.allclose(g, w, rtol=RTOL, atol=ATOL))
    smoke.check(name, ok, f"shape {tuple(got.shape)} max_abs_err {err:.6g} "
                f"bitwise-equal {equal:.6%} (rtol {RTOL}, atol {ATOL})")
    return err


def nms_case(gen, device):
    """(16, 512) xyxy boxes and scores with duplicates, equal scores,
    zero-area boxes and -inf padding."""
    import torch
    b, n = BATCH, NMS_N
    xy = torch.rand((b, n, 2), generator=gen, device=device) * 600
    wh = 5 + torch.rand((b, n, 2), generator=gen, device=device) * 120
    boxes = torch.cat([xy, xy + wh], dim=-1)
    scores = torch.rand((b, n), generator=gen, device=device)
    boxes[:, 100:140] = boxes[:, 60:100]          # exact duplicates
    scores[:, 100:140] = scores[:, 60:100]        # ... with equal scores
    scores[:, 200:260] = 0.5                      # a run of equal scores
    boxes[:, 300:330, 2:] = boxes[:, 300:330, :2]  # zero-area boxes
    boxes[:, 460:] = 0.0                          # padding
    scores[:, 460:] = -torch.inf
    return boxes, scores


def grouped_operands(x_nhwc, weight_oihw):
    """The operands of one grouped bf16 ``F.conv2d`` (groups = batch) that
    computes a per-sample conv, made once, outside the timed call: x as
    (1, B*C, H, W) and the (B*O, C, 3, 3) weight, both channels_last."""
    import torch
    b, h, w, c = x_nhwc.shape
    x = x_nhwc.to(torch.bfloat16).permute(0, 3, 1, 2).reshape(1, b * c, h, w)
    return (x.contiguous(memory_format=torch.channels_last),
            weight_oihw.to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last))


def stem_weights(k_aug):
    """K (B, O, 9C + 1), taps ki-major, kj, channel and the bias as the last
    column -> the grouped conv's bf16 weight (B*O, C, 3, 3), channels_last,
    and bias (B*O,)."""
    import torch
    b, o, n = k_aug.shape
    c = (n - 1) // 9
    weight = k_aug[..., :-1].reshape(b, o, 3, 3, c).permute(0, 1, 4, 2, 3)
    return (weight.reshape(b * o, c, 3, 3).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last),
        k_aug[..., -1].reshape(b * o).to(torch.bfloat16))


def library_stem(x_nhwc, k_aug, stride: int):
    """Kernel A's or B's function as one library call."""
    import torch.nn.functional as F
    b = x_nhwc.shape[0]
    wq, bias = stem_weights(k_aug)
    x, _ = grouped_operands(x_nhwc, wq)
    return lambda: F.silu(F.conv2d(x, wq, bias, stride=stride, padding=1,
                                   groups=b))


def library_stem_fused(x_nhwc, k1, k2):
    """Kernel E's function as two library calls, the second on the first's
    output as it lies: one (1, 32 B, H, W) bf16 map."""
    import torch.nn.functional as F
    b = x_nhwc.shape[0]
    (w1, b1), (w2, b2) = stem_weights(k1), stem_weights(k2)
    x, _ = grouped_operands(x_nhwc, w1)
    return lambda: F.silu(F.conv2d(
        F.silu(F.conv2d(x, w1, b1, padding=1, groups=b)), w2, b2, stride=2,
        padding=1, groups=b))


def library_block(x_nhwc, w1, k2, k3):
    """Kernel G's function as three shared-weight bf16 channels_last convs
    with their leaky and the residual add."""
    import torch
    import torch.nn.functional as F

    def operands(k_aug, ksize):
        kq = k_aug.to(torch.bfloat16)
        o = kq.shape[0]
        weight = kq[:, :-1].reshape(o, ksize, ksize, -1).permute(0, 3, 1, 2)
        return (weight.contiguous(memory_format=torch.channels_last),
                kq[:, -1].contiguous())

    x = x_nhwc.permute(0, 3, 1, 2)   # NCHW view of NHWC memory
    (wa, ba), (wb, bb), (wc, bc) = (operands(w1, 1), operands(k2, 3),
                                    operands(k3, 3))

    def run():
        z = F.leaky_relu(F.conv2d(x, wa, ba), 0.1)
        y = F.leaky_relu(F.conv2d(z, wb, bb, padding=1), 0.1) + x
        return F.leaky_relu(F.conv2d(y, wc, bc, stride=2, padding=1), 0.1)

    return run


def library_dyconv(x, k, mul, add):
    """Kernel D's function as one library call plus its affine and SiLU."""
    import torch
    import torch.nn.functional as F
    b, h, w, c = x.shape
    co = k.shape[-1]
    xq, wq = grouped_operands(
        x, k.permute(0, 3, 2, 1).reshape(b * co, c, 3, 3))
    m = mul.to(torch.bfloat16)[None, :, None, None]
    a = add.to(torch.bfloat16)[:, :, None, None]
    return lambda: F.silu(F.conv2d(xq, wq, padding=1, groups=b).reshape(
        b, co, h, w) * m + a)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is visible")
    from uavdet_tpu_torch.utils.timing import card_line
    card = card_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from uavdet_tpu_torch import kernels
    from uavdet_tpu_torch.inference import (decode_topk_global,
                                            make_detector, preprocess,
                                            preprocess_dual,
                                            select_detections)
    from uavdet_tpu_torch.models import BASELINE, DYSOEM, DYYOLO
    from uavdet_tpu_torch.ops.block import (BLOCK_EDGE_SHAPES, BLOCK_STAGES,
                                            fold_block_weights,
                                            pack_block_weights,
                                            post_stem_block,
                                            post_stem_block_plain)
    from uavdet_tpu_torch.ops.dyconv import (EDGE_SHAPES, dyconv,
                                             dyconv_plain, parity_sums,
                                             rfold)
    from uavdet_tpu_torch.ops.nms import (NMS_EDGE_CASES, batched_nms,
                                          nms_alive, nms_alive_plain,
                                          nms_edge_case, nms_empty_launch,
                                          nms_phase_ms)
    from uavdet_tpu_torch.ops.stem import (L1_EDGE_SHAPES, L2_EDGE_SHAPES,
                                           L2_STAGES,
                                           detector_stem_fast_path,
                                           fused_stem_forward, stem_fused,
                                           stem_fused_plain, stem_l1,
                                           stem_l1_plain, stem_l1_weights,
                                           stem_l2, stem_l2_plain,
                                           stem_l2_stage, stem_l2_weights)
    from uavdet_tpu_torch.scripts import block_ablate, l2_ablate
    from uavdet_tpu_torch.utils.seeding import seeded_model

    smoke = Smoke()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tag = f"[{card}]"

    def build():
        info = kernels.build()
        kernels.library()
        print(f"nvcc build {info.seconds:.1f} s -> {info.path.name}")
        for line in info.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("  " + line.strip())
        smoke.check("build", True, f"{len(KERNELS)} kernels")

    smoke.phase("1 build", build)

    t0 = time.perf_counter()
    # device and dtype are the entry point's defaults: the card, bf16
    model = seeded_model("DyYOLO", DYYOLO, SEED)
    dy0, dy1, temp = model.layers[0], model.layers[1], model.attn_temperature
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: DyYOLO full width, {n_params} parameters, seed {SEED}, "
          f"built in {time.perf_counter() - t0:.1f} s")
    frames = torch.randint(0, 256, (BATCH, SIZE, SIZE, 3), dtype=torch.uint8,
                           device=dev, generator=gen)
    inputs = {}

    def sums_close(name, got, want, rtol):
        # sums of ~10^5 stored values: a bf16 ulp that falls the other way
        # moves a sum by 2^-8 of one value, so the error is held against the
        # largest sum, not against each (possibly cancelling) one
        err = float((got - want).abs().max())
        top = float(want.abs().max())
        smoke.check(name, err <= rtol * top, f"max_abs_err {err:.6g} of "
                    f"{top:.6g} (rtol {rtol} of the largest sum)")

    @torch.inference_mode()
    def kernel_a():
        k1 = stem_l1_weights(frames, dy0, temp)
        a1, sums = stem_l1(frames, k1)
        a1_p, sums_p = stem_l1_plain(frames, k1)
        err = compare_bf16(smoke, f"stem_l1 uint8 {tuple(frames.shape)}",
                           a1, a1_p)
        smoke.stats["stem_l1"]["max_abs_err"] = err
        smoke.check("stem_l1 uint8 sums", torch.allclose(
            sums, sums_p, rtol=1e-3, atol=1e-2), "max_abs_err "
            f"{float((sums - sums_p).abs().max()):.6g} of "
            f"{float(sums_p.abs().max()):.6g} (rtol 1e-3)")
        inputs["l1"] = (frames, k1)
        inputs["l2"] = (a1, stem_l2_weights(sums, SIZE * SIZE, dy1, temp))
        smoke.stats["stem_l1"].update(bound(
            nbytes(frames, a1, sums) + k1.numel() * 2,
            2 * 27 * 32 * BATCH * SIZE * SIZE, BF16_FLOPS))
        odd = torch.rand((2, 97, 161, 3), generator=gen, device=dev)
        odd = odd.to(torch.bfloat16)
        k1 = stem_l1_weights(odd, dy0, temp)
        a1, sums = stem_l1(odd, k1)
        a1_p, sums_p = stem_l1_plain(odd, k1)
        compare_bf16(smoke, "stem_l1 bf16 (2,97,161,3) a1", a1, a1_p)
        smoke.check("stem_l1 bf16 sums", torch.allclose(
            sums, sums_p, rtol=1e-3, atol=1e-2), "max_abs_err "
            f"{float((sums - sums_p).abs().max()):.6g}")
        k2 = stem_l2_weights(sums, 97 * 161, dy1, temp)
        compare_bf16(smoke, "stem_l2 (2,97,161,32) -> (2,49,81,64)",
                     stem_l2(a1, k2), stem_l2_plain(a1, k2))
        for b, h, w in L1_EDGE_SHAPES:
            u8 = torch.randint(0, 256, (b, h, w, 3), dtype=torch.uint8,
                               device=dev, generator=gen)
            for x in (u8, (u8.float() / 255.0).to(torch.bfloat16)):
                k1 = 0.3 * torch.randn((b, 32, 28), generator=gen, device=dev)
                if x.dtype == torch.uint8:   # /255 folded into the taps
                    k1[..., :27] /= 255.0
                label = f"stem_l1 edge {tuple(x.shape)} {x.dtype}"
                a1, sums = stem_l1(x, k1)
                a1_p, sums_p = stem_l1_plain(x, k1)
                compare_bf16(smoke, label, a1, a1_p)
                sums_close(f"{label} sums", sums, sums_p, 1e-3)
                again, sums_again = stem_l1(x, k1)
                smoke.check(f"{label} twice on the same input",
                            torch.equal(again, a1)
                            and torch.equal(sums_again, sums),
                            "output and sums bitwise equal")

    @torch.inference_mode()
    def kernel_b():
        a1, k2 = inputs["l2"]
        out = stem_l2(a1, k2)
        err = compare_bf16(smoke, f"stem_l2 {tuple(a1.shape)} -> "
                           f"{tuple(out.shape)}", out, stem_l2_plain(a1, k2))
        smoke.stats["stem_l2"]["max_abs_err"] = err
        smoke.stats["stem_l2"].update(bound(
            nbytes(a1, out) + k2.numel() * 2,
            2 * 288 * 64 * out.numel() // 64, BF16_FLOPS))
        for b, h, w in L2_EDGE_SHAPES:
            a1 = 0.5 * torch.randn((b, h, w, 32), generator=gen, device=dev)
            k2 = 0.08 * torch.randn((b, 64, 289), generator=gen, device=dev)
            a1 = a1.to(torch.bfloat16)
            out = stem_l2(a1, k2)
            compare_bf16(smoke, f"stem_l2 edge {tuple(a1.shape)} -> "
                         f"{tuple(out.shape)}", out, stem_l2_plain(a1, k2))

    @torch.inference_mode()
    def kernel_nms():
        boxes, scores = nms_case(gen, dev)
        order = torch.argsort(-scores, dim=1, stable=True)
        boxes_s = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
        alive, alive_p = nms_alive(boxes_s, 0.5), nms_alive_plain(boxes_s, 0.5)
        diff = int((alive != alive_p).sum())
        smoke.check(f"nms alive {tuple(alive.shape)} bitwise", diff == 0,
                    f"{diff} of {alive.numel()} differ; {int(alive.sum())} "
                    "survivors")
        smoke.stats["nms"]["max_abs_err"] = float(diff != 0)
        got = batched_nms(boxes, scores, 0.5, 300)
        want = batched_nms(boxes, scores, 0.5, 300, alive_fn=nms_alive_plain)
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        smoke.check("batched_nms keep_idx/alive/order bitwise", same, "")
        inputs["nms"] = boxes_s
        rng = np.random.default_rng(SEED)
        for kind, b, n in NMS_EDGE_CASES:
            eb, es = (torch.from_numpy(a).to(dev)
                      for a in nms_edge_case(kind, b, n, rng))
            order = torch.argsort(-es, dim=1, stable=True)
            eb_s = torch.gather(eb, 1, order[..., None].expand(-1, -1, 4))
            got, want = nms_alive(eb_s, 0.5), nms_alive_plain(eb_s, 0.5)
            diff = int((got != want).sum())
            keep = batched_nms(eb, es, 0.5, min(n, 300))
            keep_p = batched_nms(eb, es, 0.5, min(n, 300),
                                 alive_fn=nms_alive_plain)
            same = all(torch.equal(g, w) for g, w in zip(keep, keep_p))
            smoke.check(f"nms edge {kind} ({b}, {n}) bitwise",
                        diff == 0 and same, f"{diff} of {got.numel()} differ; "
                        f"{int(got.sum())} survivors; batched_nms equal "
                        f"{same}")
        # the shape timed past 1024 boxes, checked once here
        b, n = BATCH, NMS_LARGE_N
        eb, es = (torch.from_numpy(a).to(dev)
                  for a in nms_edge_case("crowded", b, n, rng))
        order = torch.argsort(-es, dim=1, stable=True)
        big = torch.gather(eb, 1, order[..., None].expand(-1, -1, 4))
        got = nms_alive(big, 0.5)
        diff = int((got != nms_alive_plain(big, 0.5)).sum())
        smoke.check(f"nms ({b}, {n}) bitwise", diff == 0,
                    f"{diff} of {got.numel()} differ; {int(got.sum())} "
                    "survivors")
        inputs["nms_large"] = big.contiguous()
        # csrc/nms.cu: 5 f32 operations per box area, 14 per IoU of a pair
        # (i, j > i): 4 min/max, 2 differences, 2 clamps, 1 product, the
        # union's sum and difference, its clamp, the quotient, the compare
        b, n = alive.shape
        smoke.stats["nms"].update(bound(
            nbytes(boxes_s, alive), b * (5 * n + 14 * n * (n - 1) // 2),
            F32_FLOPS))

    smoke.phase("2 kernel A", kernel_a)
    smoke.phase("3 kernel B", kernel_b)
    smoke.phase("4 NMS", kernel_nms)

    t0 = time.perf_counter()
    soem_model = seeded_model("DySOEM_SimFPN", DYSOEM, SEED)
    n_params = sum(p.numel() for p in soem_model.parameters())
    print(f"model: DySOEM_SimFPN full width, {n_params} parameters, seed "
          f"{SEED}, built in {time.perf_counter() - t0:.1f} s")
    for name, m in (("DyYOLO", model), ("DySOEM_SimFPN", soem_model)):
        where = {(p.device.type, p.dtype) for p in m.parameters()}
        smoke.check(f"{name} built with no device or dtype named",
                    where == {("cuda", torch.bfloat16)}, f"{where}")
    soem_frames = torch.randint(0, 256, (SOEM_BATCH, SOEM_SIZE, SOEM_SIZE, 3),
                                dtype=torch.uint8, device=dev, generator=gen)
    sites = []   # (x, k, mul, add, emit_gap) as each SOEM site calls kernel D

    def check_dyconv(label, x, k, mul, add, fold: bool):
        want, want_sums = dyconv_plain(x, k, mul, add, emit_gap=True)
        got = dyconv(x, k, mul, add)
        err = compare_bf16(smoke, f"dyconv {label} {tuple(x.shape)} -> "
                           f"{tuple(got.shape)}", got, want)
        got_g, sums = dyconv(x, k, mul, add, emit_gap=True)
        smoke.check(f"dyconv {label} emit_gap leaves the output as it is",
                    torch.equal(got_g, got), "bitwise")
        again, sums_again = dyconv(x, k, mul, add, emit_gap=True)
        smoke.check(f"dyconv {label} emit_gap twice on the same input",
                    torch.equal(again, got_g)
                    and torch.equal(sums_again, sums),
                    "output and sums bitwise equal")
        sums_close(f"dyconv {label} emit_gap sums vs plain", sums, want_sums,
                   1e-3)
        sums_close(f"dyconv {label} emit_gap sums vs its own stored output",
                   sums, parity_sums(got), 1e-5)
        if fold:
            folded = dyconv(x, k, mul, add, fold_out=True)
            smoke.check(f"dyconv {label} fold_out == rfold(out)",
                        torch.equal(folded, rfold(got)),
                        f"bitwise, {tuple(folded.shape)}")
            compare_bf16(smoke, f"dyconv {label} fold_out vs plain", folded,
                         dyconv_plain(x, k, mul, add, fold_out=True))
        return err

    def check_full_batch(label, x, k, mul, add, emit):
        """The launch the main path makes at this site, all images at once,
        against the plain version a few images at a time. -> max abs error."""
        res = dyconv(x, k, mul, add, emit_gap=emit)
        got, sums = res if emit else (res, None)
        n, ok, err, sum_err, sum_top = SOEM_CHECK_BATCH, True, 0.0, 0.0, 0.0
        for s in range(0, x.shape[0], n):
            want, want_sums = dyconv_plain(x[s:s + n], k[s:s + n], mul,
                                           add[s:s + n], emit_gap=True)
            g, w = got[s:s + n].float(), want.float()
            ok = ok and bool(torch.isfinite(g).all()) and torch.allclose(
                g, w, rtol=RTOL, atol=ATOL)
            err = max(err, float((g - w).abs().max()))
            if emit:
                sum_err = max(sum_err, float(
                    (sums[s:s + n] - want_sums).abs().max()))
                sum_top = max(sum_top, float(want_sums.abs().max()))
        ok = ok and sum_err <= 1e-3 * sum_top
        smoke.check(f"dyconv {label} one launch of {x.shape[0]} images, all "
                    f"held against plain {n} at a time", ok,
                    f"max_abs_err {err:.6g} (rtol {RTOL}, atol {ATOL})"
                    + (f"; sums max_abs_err {sum_err:.6g} of {sum_top:.6g} "
                       "(rtol 1e-3 of the largest sum)" if emit else ""))
        return err

    @torch.inference_mode()
    def kernel_d():
        # sizes on both sides of the kernel's pixel tile, K chunk and N tiles
        for b, h, w, c, co in EDGE_SHAPES:
            x = torch.randn((b, h, w, c), generator=gen, device=dev)
            k = torch.randn((b, 9, c, co), generator=gen, device=dev) \
                * (2.0 / (9 * c)) ** 0.5
            mul = 0.5 + torch.rand((co,), generator=gen, device=dev)
            add = 0.3 * torch.randn((b, co), generator=gen, device=dev)
            check_dyconv("edge", x.to(torch.bfloat16), k.to(torch.bfloat16),
                         mul, add, fold=h % 2 == 0)

        def recording(x, k, mul, add, emit_gap=False):
            sites.append((x, k, mul, add, emit_gap))
            return dyconv(x, k, mul, add, emit_gap=emit_gap)

        soem_model(preprocess(soem_frames, SOEM_SIZE), conv=recording)
        smoke.check("dyconv sites", len(sites) == 3,
                    f"{[tuple(s[0].shape) for s in sites]} -> "
                    f"{[s[1].shape[-1] for s in sites]} channels, emit_gap "
                    f"{[s[4] for s in sites]}")
        errs, total = [], {"bytes": 0, "operations": 0, "bound_ms": 0.0}
        n = SOEM_CHECK_BATCH
        for i, (x, k, mul, add, emit) in enumerate(sites):
            errs.append(check_dyconv(f"soem_{i}", x[:n], k[:n], mul, add[:n],
                                     fold=i == 0))
            errs.append(check_full_batch(f"soem_{i}", x, k, mul, add, emit))
            bb, hh, ww, cc = x.shape
            oc = k.shape[-1]
            site = bound(nbytes(x, k, mul, add) + bb * hh * ww * oc * 2,
                         2 * 9 * cc * oc * bb * hh * ww, BF16_FLOPS)
            print(f"  soem_{i} bound {site}")
            for key in total:
                total[key] += site[key]
            inputs[f"dyconv_{i}"] = site
        smoke.stats["dyconv"]["max_abs_err"] = max(errs)
        # the three sites of one request: their bounds add up, and the sum
        # is bound by what bounds the larger part of it
        by = {"bytes": 0.0, "operations": 0.0}
        for i in range(len(sites)):
            site = inputs[f"dyconv_{i}"]
            by[site["bound_by"]] += site["bound_ms"]
        smoke.stats["dyconv"].update(total, bound_by=max(by, key=by.get))

    smoke.phase("5 kernel D", kernel_d)

    def stem_ops(shape):
        """2 x 27 x 32 per pixel of the first layer + 2 x 288 x 64 per pixel
        of the second."""
        b, h, w, _ = shape
        return 2 * b * (27 * 32 * h * w
                        + 288 * 64 * ((h + 1) // 2) * ((w + 1) // 2))

    @torch.inference_mode()
    def kernel_e():
        x, k1 = inputs["l1"]
        a1, k2 = inputs["l2"]
        out = stem_fused(x, k1, k2)
        err = compare_bf16(smoke, f"stem_fused uint8 {tuple(x.shape)} -> "
                           f"{tuple(out.shape)} vs plain", out,
                           stem_fused_plain(x, k1, k2))
        smoke.stats["stem_fused"]["max_abs_err"] = err
        smoke.check("stem_fused uint8 == stem_l2(stem_l1), bitwise",
                    torch.equal(out, stem_l2(a1, k2)), f"{tuple(out.shape)}")
        smoke.stats["stem_fused"].update(bound(
            nbytes(x, out) + (k1.numel() + k2.numel()) * 2,
            stem_ops(x.shape), BF16_FLOPS))
        odd = torch.rand((2, 97, 161, 3), generator=gen, device=dev)
        odd = odd.to(torch.bfloat16)
        k1 = stem_l1_weights(odd, dy0, temp)
        a1, sums = stem_l1(odd, k1)
        k2 = stem_l2_weights(sums, 97 * 161, dy1, temp)
        out = stem_fused(odd, k1, k2)
        compare_bf16(smoke, "stem_fused bf16 (2,97,161,3) -> (2,49,81,64) "
                     "vs plain", out, stem_fused_plain(odd, k1, k2))
        smoke.check("stem_fused bf16 odd == stem_l2(stem_l1), bitwise",
                    torch.equal(out, stem_l2(a1, k2)), f"{tuple(out.shape)}")
        # its path: the public op, as a caller that holds K1 and K2 calls it
        x, k1 = inputs["l1"]
        k2 = inputs["l2"][1]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        outs = [stem_fused(x, k1, k2) for _ in range(REQUESTS)]
        torch.cuda.synchronize()
        count_launches(smoke, kernels, "stem_fused op", REQUESTS)
        smoke.check("stem_fused op results", all(
            o.shape == (BATCH, SIZE // 2, SIZE // 2, 64)
            and bool(torch.isfinite(o.float()).all()) for o in outs),
            f"{REQUESTS} x {tuple(outs[0].shape)} finite")

    def run_ladder(name, entry, stages):
        """A ladder's command-line entry as its path: every stage launched
        and timed by the script's own ``main``."""
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        rc = entry.main(["--iters", str(LADDER_ITERS)])
        torch.cuda.synchronize()
        smoke.check(f"{name} main", rc == 0, f"returned {rc}; stages "
                    f"{list(stages)}")
        count_launches(smoke, kernels, name, 1)

    @torch.inference_mode()
    def kernel_f():
        a1, k2 = inputs["l2"]
        full, ref = stem_l2_stage(a1, k2, "full"), stem_l2(a1, k2)
        smoke.check("stem_l2_stage full == stem_l2, bitwise",
                    torch.equal(full, ref), f"{tuple(full.shape)}")
        err = compare_bf16(smoke, "stem_l2_stage full vs plain", full,
                           stem_l2_plain(a1, k2))
        smoke.stats["stem_l2_stage"]["max_abs_err"] = err
        smoke.stats["stem_l2_stage"].update(
            {k: smoke.stats["stem_l2"][k] for k in
             ("bound_ms", "bound_by", "bytes", "operations")})
        run_ladder("l2_ablate", l2_ablate, L2_STAGES)

    def check_block(label, x, w1, k2, k3, packed=None):
        """The kernel (on the packed weights where given) against its plain
        version, and a second launch bitwise equal to the first."""
        ws = packed if packed is not None else (w1, k2, k3)
        got = post_stem_block(x, *ws)
        want = post_stem_block_plain(x, w1, k2, k3)
        err = compare_bf16(smoke, f"post_stem_block {label} "
                           f"{tuple(x.shape)} -> {tuple(got.shape)}", got,
                           want)
        smoke.check(f"post_stem_block {label} twice on the same input",
                    torch.equal(post_stem_block(x, *ws), got), "bitwise")
        return got, err

    @torch.inference_mode()
    def kernel_g():
        w1, k2, k3 = fold_block_weights(model)
        packed = pack_block_weights(w1, k2, k3)
        x = stem_l2(*inputs["l2"])        # what the block sees in DyYOLO
        inputs["block"] = (x, packed)
        got, err = check_block("DyYOLO's weights", x, w1, k2, k3, packed)
        smoke.check("post_stem_block packed once == packed per call",
                    torch.equal(post_stem_block(x, w1, k2, k3), got),
                    "bitwise")
        smoke.stats["post_stem_block"]["max_abs_err"] = err
        b, h, w, _ = x.shape
        ho, wo = (h + 1) // 2, (w + 1) // 2
        smoke.stats["post_stem_block"].update(bound(
            nbytes(x) + b * ho * wo * 128 * 2
            + (w1.numel() + k2.numel() + k3.numel()) * 2,
            2 * b * (h * w * (64 * 32 + 288 * 64) + ho * wo * 576 * 128),
            BF16_FLOPS))
        odd = torch.randn((2, 37, 45, 64), generator=gen, device=dev)
        check_block("odd", odd.to(torch.bfloat16), w1, k2, k3, packed)
        for shape in BLOCK_EDGE_SHAPES:
            edge = torch.randn((*shape, 64), generator=gen, device=dev)
            check_block("edge", edge.to(torch.bfloat16), w1, k2, k3, packed)
        # biases of the size of the activations: with leaky(bias) in place
        # of zero outside the image, every border output would be off
        small = torch.randn((3, 16, 24, 64), generator=gen, device=dev)
        big = [torch.cat([k[:, :-1], torch.full_like(k[:, -1:], v)], dim=1)
               for k, v in ((w1, 1.0), (k2, -1.5), (k3, 0.5))]
        check_block("border, large biases", small.to(torch.bfloat16), *big,
                    pack_block_weights(*big))
        run_ladder("block_ablate", block_ablate, BLOCK_STAGES)

    smoke.phase("5e kernel E", kernel_e)
    smoke.phase("5f kernel F", kernel_f)
    smoke.phase("5g kernel G", kernel_g)

    detect = make_detector(model, DYYOLO, SIZE)
    anchors = DYYOLO.anchors

    @torch.inference_mode()
    def main_path():
        requests = [torch.randint(0, 256, (BATCH, SIZE, SIZE, 3),
                                  dtype=torch.uint8, device=dev,
                                  generator=gen) for _ in range(REQUESTS)]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        results = [detect(r) for r in requests]
        torch.cuda.synchronize()
        count_launches(smoke, kernels, "DyYOLO", REQUESTS)
        check_requests(smoke, results, BATCH)
        compare_with_plain_stem(requests[0], results[0])

    def compare_with_plain_stem(x, result):
        """DyYOLO on the frames x (raw uint8 at the detector's size, or
        preprocessed), with the plain versions in place of the kernels."""
        fast = detector_stem_fast_path(model)
        a_k = fast.stem(x)
        a_p = fused_stem_forward(x, dy0, dy1, temp, l1=stem_l1_plain,
                                 l2=stem_l2_plain)
        compare_bf16(smoke, f"stem output {tuple(a_p.shape)}", a_k, a_p)
        outs_k, outs_p = fast.tail(a_k), fast.tail(a_p)
        compare_heads(smoke, outs_k, outs_p)
        scales = [SIZE // o.obj.shape[2] for o in outs_p]
        boxes, scores = decode_topk_global(outs_p, anchors, scales, 512)
        plain = select_detections(boxes, scores, 0.001, 0.5, 300,
                                  alive_fn=nms_alive_plain)
        compare_detections(smoke, result, plain)

    smoke.phase("6 main path 1: DyYOLO", main_path)

    soem_detect = make_detector(soem_model, DYSOEM, SOEM_SIZE)

    @torch.inference_mode()
    def main_path_soem():
        shape = (SOEM_BATCH, SOEM_SIZE, SOEM_SIZE, 3)
        requests = [torch.randint(0, 256, shape, dtype=torch.uint8,
                                  device=dev, generator=gen)
                    for _ in range(REQUESTS)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        results = [soem_detect(r) for r in requests]
        torch.cuda.synchronize()
        count_launches(smoke, kernels, "DySOEM_SimFPN", REQUESTS)
        print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
              f" GiB {tag}")
        check_requests(smoke, results, SOEM_BATCH)

        # the first frames of the first batch, with the plain versions in
        # place of the kernels (the f32 copies of the plain dyconv bound
        # how many frames fit)
        n = SOEM_PLAIN_FRAMES
        x = preprocess(requests[0][:n], SOEM_SIZE)
        outs_k = soem_model(x)
        outs_p = soem_model(x, conv=dyconv_plain)
        print(f"plain versions on the first {n} of {SOEM_BATCH} frames")
        compare_heads(smoke, outs_k, outs_p)
        scales = [SOEM_SIZE // o.obj.shape[2] for o in outs_p]
        plain = select_detections(
            *decode_topk_global(outs_p, DYSOEM.anchors, scales, 512), 0.001,
            0.5, 300, alive_fn=nms_alive_plain)
        compare_detections(smoke, soem_detect(requests[0][:n]), plain)

    smoke.phase("7 main path 2: DySOEM_SimFPN", main_path_soem)

    t0 = time.perf_counter()
    base_model = seeded_model("baseline", BASELINE, SEED)
    n_params = sum(p.numel() for p in base_model.parameters())
    print(f"model: BaselineModel full width, {n_params} parameters, seed "
          f"{SEED}, built in {time.perf_counter() - t0:.1f} s")
    base_detect = make_detector(base_model, BASELINE, SIZE)
    dual_detect = make_detector(model, DYYOLO, SIZE, dual=True)

    def uint8_frames(batch, hw):
        return torch.randint(0, 256, (batch, *hw, 3), dtype=torch.uint8,
                             device=dev, generator=gen)

    @torch.inference_mode()
    def main_path_baseline():
        requests = [uint8_frames(1, (SIZE, SIZE)) for _ in range(REQUESTS)]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        results = [base_detect(r) for r in requests]
        torch.cuda.synchronize()
        count_launches(smoke, kernels, "baseline", REQUESTS)
        check_requests(smoke, results, 1)
        # the plain path: the same eager model, the plain NMS
        outs = base_model(preprocess(requests[0], SIZE))
        scales = [SIZE // o.obj.shape[2] for o in outs]
        plain = select_detections(
            *decode_topk_global(outs, BASELINE.anchors, scales, 512), 0.001,
            0.5, 300, alive_fn=nms_alive_plain)
        compare_detections(smoke, results[0], plain)

    @torch.inference_mode()
    def main_path_dual():
        requests = [(uint8_frames(DUAL_BATCH, RGB_HW),
                     uint8_frames(DUAL_BATCH, IR_HW))
                    for _ in range(REQUESTS)]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        results = [dual_detect(rgb, ir) for rgb, ir in requests]
        torch.cuda.synchronize()
        count_launches(smoke, kernels, "DyYOLO dual", REQUESTS)
        check_requests(smoke, results, 2 * DUAL_BATCH)
        x = preprocess_dual(*requests[0], SIZE)
        smoke.check("preprocess_dual",
                    x.shape == (2 * DUAL_BATCH, SIZE, SIZE, 3)
                    and x.dtype == torch.bfloat16
                    and 0.0 <= float(x.min()) and float(x.max()) <= 1.0,
                    f"{tuple(x.shape)} {x.dtype} in [{float(x.min()):.3f}, "
                    f"{float(x.max()):.3f}]")
        inputs["dual"] = requests[0]
        compare_with_plain_stem(x, results[0])

    smoke.phase("7b main path 3: BaselineModel", main_path_baseline)
    smoke.phase("7c main path 4: DyYOLO dual-stream", main_path_dual)

    topk = NMS_LARGE_N
    topk_detect = make_detector(model, DYYOLO, SIZE, pre_nms_topk=topk)

    @torch.inference_mode()
    def main_path_topk():
        """More candidates than a cluster's shared memory holds (25,200 at
        640 px): the NMS kernel keeps its mask in device memory."""
        requests = [uint8_frames(BATCH, (SIZE, SIZE))
                    for _ in range(REQUESTS)]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        results = [topk_detect(r) for r in requests]
        torch.cuda.synchronize()
        count_launches(smoke, kernels, "DyYOLO pre_nms_topk 4096", REQUESTS)
        check_requests(smoke, results, BATCH)
        fast = detector_stem_fast_path(model)
        outs = fast.tail(fast.stem(requests[0]))
        scales = [SIZE // o.obj.shape[2] for o in outs]
        boxes, scores = decode_topk_global(outs, anchors, scales, topk)
        smoke.check("pre_nms_topk candidates", boxes.shape[1] == topk,
                    f"{tuple(boxes.shape)}")
        plain = select_detections(boxes, scores, 0.001, 0.5, 300,
                                  alive_fn=nms_alive_plain)
        compare_detections(smoke, results[0], plain)

    t0 = time.perf_counter()
    f32_model = seeded_model("DySOEM_SimFPN", DYSOEM, SEED,
                             dtype=torch.float32)
    f32_cpu = seeded_model("DySOEM_SimFPN", DYSOEM, SEED, "cpu",
                           torch.float32)
    print(f"model: DySOEM_SimFPN full width, float32, on the card and on "
          f"the CPU, built in {time.perf_counter() - t0:.1f} s")

    @torch.inference_mode()
    def main_path_soem_f32():
        """No kernel claims a float32 SOEM: the grouped conv serves it (TF32
        off, as set above), held against the CPU."""
        detect_f32 = make_detector(f32_model, DYSOEM, F32_SIZE,
                                   compute_dtype=torch.float32)
        requests = [uint8_frames(F32_BATCH, (F32_SIZE, F32_SIZE))
                    for _ in range(REQUESTS)]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        results = [detect_f32(r) for r in requests]
        torch.cuda.synchronize()
        count_launches(smoke, kernels, "DySOEM_SimFPN float32", REQUESTS)
        check_requests(smoke, results, F32_BATCH)
        cpu = make_detector(f32_cpu, DYSOEM, F32_SIZE,
                            compute_dtype=torch.float32)(requests[0].cpu())
        cpu = type(cpu)(*(t.to(dev) for t in cpu))
        compare_detections(smoke, results[0], cpu, F32_LOGIT_TOL,
                           "float32 detections on the card vs the CPU")

    smoke.phase("7d main path 5: DyYOLO, pre_nms_topk 4096", main_path_topk)
    smoke.phase("7e main path 6: DySOEM_SimFPN float32", main_path_soem_f32)

    def time_pair(name, kern, plain, lib, iters=ITERS, warmup=WARMUP,
                  plain_iters=ITERS, plain_warmup=WARMUP):
        """Kernel and plain version in turns, so that neither side owns the
        card's warm state; then the library call."""
        k1 = cuda_ms(kern, iters, warmup)
        p1 = cuda_ms(plain, plain_iters, plain_warmup)
        k2 = cuda_ms(kern, iters, warmup)
        p2 = cuda_ms(plain, plain_iters, plain_warmup)
        lib_ms = None if lib is None else cuda_ms(lib, iters, warmup)
        burst = back_to_back_ms(kern, iters)
        print(f"{name}: kernel {k1:.4f} / {k2:.4f} ms ({burst:.4f} back to "
              f"back), plain {p1:.4f} / {p2:.4f} ms, library "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'} {tag}")
        return {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                "library_ms": lib_ms, "back_to_back_ms": burst}

    @torch.inference_mode()
    def timing():
        ms = cuda_ms(lambda: detect(frames))
        print(f"detector DyYOLO @{SIZE} bs={BATCH} uint8 -> Detections: "
              f"{ms:.3f} ms/batch, {BATCH * 1000.0 / ms:.1f} fps {tag}")
        ms = cuda_ms(lambda: soem_detect(soem_frames), SOEM_ITERS,
                     SOEM_WARMUP)
        print(f"detector DySOEM_SimFPN @{SOEM_SIZE} bs={SOEM_BATCH} uint8 -> "
              f"Detections: {ms:.3f} ms/batch, "
              f"{SOEM_BATCH * 1000.0 / ms:.1f} fps (median of {SOEM_ITERS}) "
              f"{tag}")
        frame = frames[:1]
        ms = cuda_ms(lambda: base_detect(frame))
        print(f"detector BaselineModel @{SIZE} bs=1 uint8 -> Detections: "
              f"{ms:.3f} ms/batch, {1000.0 / ms:.1f} fps {tag}")
        rgb, ir = inputs["dual"]
        ms = cuda_ms(lambda: dual_detect(rgb, ir))
        print(f"detector DyYOLO dual @{SIZE} {DUAL_BATCH} RGB {RGB_HW} + "
              f"{DUAL_BATCH} IR {IR_HW} uint8 -> Detections: {ms:.3f} "
              f"ms/batch, {2 * DUAL_BATCH * 1000.0 / ms:.1f} fps {tag}")
        x, k1 = inputs["l1"]
        smoke.stats["stem_l1"].update(time_pair(
            "stem_l1", lambda: stem_l1(x, k1), lambda: stem_l1_plain(x, k1),
            library_stem(x, k1, 1)))
        a1, k2 = inputs["l2"]
        smoke.stats["stem_l2"].update(time_pair(
            "stem_l2", lambda: stem_l2(a1, k2), lambda: stem_l2_plain(a1, k2),
            library_stem(a1, k2, 2)))
        smoke.stats["stem_fused"].update(time_pair(
            "stem_fused", lambda: stem_fused(x, k1, k2),
            lambda: stem_fused_plain(x, k1, k2),
            library_stem_fused(x, k1, k2)))
        ab = smoke.stats["stem_l1"]["ms"] + smoke.stats["stem_l2"]["ms"]
        smoke.stats["stem_fused"]["stem_l1_plus_stem_l2_ms"] = ab
        print(f"  beside kernel A + kernel B: {ab:.4f} ms")
        smoke.stats["stem_l2_stage"].update(time_pair(
            "stem_l2_stage full", lambda: stem_l2_stage(a1, k2, "full"),
            lambda: stem_l2_plain(a1, k2), library_stem(a1, k2, 2)))
        xb, packed = inputs["block"]
        augs = [p.aug for p in packed]
        smoke.stats["post_stem_block"].update(time_pair(
            "post_stem_block (weights packed once)",
            lambda: post_stem_block(xb, *packed),
            lambda: post_stem_block_plain(xb, *augs),
            library_block(xb, *augs)))
        row = kernel_row_ms(lambda: post_stem_block(xb, *packed),
                            "post_stem_block_kernel", ITERS)
        smoke.stats["post_stem_block"]["profiler_row_ms"] = row
        print(f"  the kernel alone (profiler row): {row} ms {tag}")
        res, down = model.layers[2], model.layers[3]
        xn = xb.permute(0, 3, 1, 2)
        eager = cuda_ms(lambda: down(res(xn)))
        smoke.stats["post_stem_block"]["eager_tail_ms"] = eager
        print(f"  the same two layers of the eager tail (convs, BatchNorm, "
              f"leaky, add as separate passes): {eager:.4f} ms")
        boxes_s = inputs["nms"]
        smoke.stats["nms"].update(time_pair(
            "nms", lambda: nms_alive(boxes_s, 0.5),
            lambda: nms_alive_plain(boxes_s, 0.5), None))
        # past 1024 boxes: the mask in device memory, two launches
        big = inputs["nms_large"]
        large = time_pair(f"nms {tuple(big.shape[:2])} (mask in device "
                          "memory)", lambda: nms_alive(big, 0.5),
                          lambda: nms_alive_plain(big, 0.5), None)
        large["profiler_row_ms"] = kernel_row_ms(
            lambda: nms_alive(big, 0.5), "nms_", ITERS)
        b, n = big.shape[:2]
        large.update(bound(nbytes(big) + b * n,
                           b * (5 * n + 14 * n * (n - 1) // 2), F32_FLOPS),
                     shape=[b, n])
        print(f"  the two kernels alone (profiler rows): "
              f"{large['profiler_row_ms']} ms {tag}")
        smoke.stats["nms"]["large"] = large
        one = boxes_s[:1].contiguous()   # BaselineModel's launch
        extra = {
            "ms_batch_1": cuda_ms(lambda: nms_alive(one, 0.5)),
            "back_to_back_ms_batch_1": back_to_back_ms(
                lambda: nms_alive(one, 0.5), 200),
            "back_to_back_ms": back_to_back_ms(
                lambda: nms_alive(boxes_s, 0.5), 200),
            "empty_launch_ms": cuda_ms(lambda: nms_empty_launch(BATCH)),
            "empty_launch_ms_batch_1": cuda_ms(
                lambda: nms_empty_launch(1)),
            "no_launch_ms": cuda_ms(lambda: None),
        }
        for key, boxes in (("phase_ms", boxes_s), ("phase_ms_batch_1", one)):
            pairs = [nms_phase_ms(boxes, 0.5) for _ in range(5)]
            extra[key] = [sorted(v)[2] for v in zip(*pairs)]
        smoke.stats["nms"].update(extra)
        print(f"  nms at (1, {NMS_N}): {extra['ms_batch_1']:.4f} ms "
              f"({extra['back_to_back_ms_batch_1']:.4f} back to back); at "
              f"({BATCH}, {NMS_N}) {extra['back_to_back_ms']:.4f} back to "
              f"back of 200; an empty launch of the same grid "
              f"{extra['empty_launch_ms']:.4f} / "
              f"{extra['empty_launch_ms_batch_1']:.4f} ms, two events with "
              f"nothing between them {extra['no_launch_ms']:.4f} ms; inside "
              f"the kernel, by the card's global timer: pair mask, walk "
              f"{extra['phase_ms']} ms at {BATCH} images, "
              f"{extra['phase_ms_batch_1']} ms at 1 {tag}")
        total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
        per_site = []
        for i, (x, k, mul, add, emit) in enumerate(sites):
            t = time_pair(
                f"dyconv soem_{i} {tuple(x.shape)} -> {k.shape[-1]} "
                f"emit_gap={emit}",
                lambda: dyconv(x, k, mul, add, emit_gap=emit),
                lambda: dyconv_plain(x, k, mul, add, emit_gap=emit),
                library_dyconv(x, k, mul, add), SOEM_ITERS, SOEM_WARMUP,
                PLAIN_ITERS, PLAIN_WARMUP)
            if emit:
                t["ms_without_emit_gap"] = cuda_ms(
                    lambda: dyconv(x, k, mul, add), SOEM_ITERS, SOEM_WARMUP)
                print(f"  without emit_gap {t['ms_without_emit_gap']:.4f} ms")
            # the same launch on all-zero operands: the same instructions and
            # bytes at a fraction of the switching power; what it gains, if
            # anything, is what the card's power limit costs on real data
            zx, zk = torch.zeros_like(x), torch.zeros_like(k)
            t["ms_zero_operands"] = cuda_ms(
                lambda: dyconv(zx, zk, mul, add, emit_gap=emit), SOEM_ITERS,
                SOEM_WARMUP)
            print(f"  on all-zero operands {t['ms_zero_operands']:.4f} ms")
            del zx, zk
            t.update(inputs[f"dyconv_{i}"], site=f"soem_{i}")
            per_site.append(t)
            for key in total:
                total[key] += t[key]
        # one request's three sites together
        smoke.stats["dyconv"].update(total, sites=per_site)

    smoke.phase("8 timing", timing)

    @torch.inference_mode()
    def profile(name, fn, batches):
        """Device time by kernel over a few batches, and the device's idle
        share."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile
        fn()
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(batches):
                fn()
            end.record()
            end.synchronize()
        wall_us = start.elapsed_time(end) * 1e3
        # kernels and copies on the card only (operator rows repeat them)
        rows = [(e.self_device_time_total, e.count, e.key)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        rows = sorted((r for r in rows if r[0] > 0), reverse=True)
        busy_us = sum(r[0] for r in rows)
        if not rows:
            print(f"profile {name}: no device time recorded (not measured)")
            return
        print(f"profile {name}: {batches} batches, device busy "
              f"{busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms, idle share "
              f"{1 - busy_us / wall_us:.3f} {tag}")
        # the 20 largest, and the port's own kernels wherever they stand
        for i, (t, n, key) in enumerate(rows):
            if i < 20 or "(anonymous namespace)::" in key:
                print(f"  {t / batches / 1e3:9.4f} ms/batch {n // batches:5d} "
                      f"calls/batch {key[:150]}")

    print("== 9 profile (informational)", flush=True)
    for args in (("DyYOLO", lambda: detect(frames), 3),
                 ("DySOEM_SimFPN", lambda: soem_detect(soem_frames), 2),
                 ("BaselineModel bs=1", lambda: base_detect(frames[:1]), 3),
                 ("DyYOLO dual", lambda: dual_detect(*inputs["dual"]), 3)):
        try:
            profile(*args)
        except Exception:   # a profiler that cannot trace the card fails nothing
            traceback.print_exc()

    if smoke.failures:
        print(f"FAILED: {smoke.failures}", flush=True)
        return 1
    rows = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
             **smoke.stats[name]} for name, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
