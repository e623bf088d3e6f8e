#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``uavdet_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It needs one CUDA device and ``nvcc`` (CUDA_HOME), and imports neither JAX
nor PyYAML. The phases, in order:

  0. the card: name and power limit (nvidia-smi); TF32 off, so that the
     plain versions' f32 convolutions stay f32;
  1. builds the CUDA kernels from ``uavdet_tpu_torch/csrc`` (nvcc, sm_90a);
  2. kernel A (stem L1) against its plain version, on uint8 frames
     (16, 640, 640, 3) and on bf16 frames of an odd shape;
  3. kernel B (stem L2) against its plain version at (16, 640, 640, 32);
  4. the NMS kernel against its plain version at (16, 512) boxes with
     duplicates, equal scores, zero-area boxes and -inf padding: bitwise;
  5. the main path: full-width DyYOLO (conf/model/dy-yolo.yaml widths),
     bf16, seeded random weights, answers 3 requests of 16 uint8 640x640
     frames through ``make_detector``; checks the results and that every
     kernel was launched once per request; then runs the same batch with
     the plain versions in place of the kernels and compares;
  6. times, with CUDA events, the median of 20 runs after warm-up: the
     detector per batch, and each kernel beside its plain version.

Any failed phase makes it exit with 1 and print no result. Otherwise the
last three lines are one JSON object of the kernels, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.
"""

import json
import statistics
import subprocess
import sys
import time
import traceback

BATCH, SIZE, REQUESTS = 16, 640, 3
ITERS, WARMUP = 20, 3
SEED = 0
NMS_N = 512
# bf16 output of an f32 sum: the kernels and their plain versions add the
# same bf16 products in another order, which can move a result across a
# bf16 rounding boundary (one ulp, 2^-8 relative), rarely further
RTOL, ATOL = 1.6e-2, 1e-2

KERNELS = {
    "stem_l1": ("uavdet_tpu_torch/csrc/stem_l1.cu",
                "uavdet_tpu/ops/pallas_stem_split.py:62"),
    "stem_l2": ("uavdet_tpu_torch/csrc/stem_l2.cu",
                "uavdet_tpu/ops/pallas_stem_split.py:256"),
    "nms": ("uavdet_tpu_torch/csrc/nms.cu", "uavdet_tpu/ops/pallas_nms.py:28"),
}


class Smoke:
    def __init__(self):
        self.failures = []
        self.stats = {name: {} for name in KERNELS}

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


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = ITERS, warmup: int = WARMUP) -> float:
    """Median device time of one call, by CUDA events, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is visible")
    card = card_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from uavdet_tpu_torch import kernels
    from uavdet_tpu_torch.inference import (decode_topk_global,
                                            make_detector, select_detections)
    from uavdet_tpu_torch.models import DYYOLO
    from uavdet_tpu_torch.ops.nms import (batched_nms, nms_alive,
                                          nms_alive_plain)
    from uavdet_tpu_torch.ops.stem import (detector_stem_fast_path,
                                           fused_stem_forward, stem_l1,
                                           stem_l1_plain, stem_l1_weights,
                                           stem_l2, stem_l2_plain,
                                           stem_l2_weights)
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
    model = seeded_model("DyYOLO", DYYOLO, SEED, dev, torch.bfloat16)
    dy0, dy1, temp = model.layers[0], model.layers[1], model.attn_temperature
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: DyYOLO full width, {n_params} parameters, bf16, "
          f"seed {SEED}, built in {time.perf_counter() - t0:.1f} s")
    frames = torch.randint(0, 256, (BATCH, SIZE, SIZE, 3), dtype=torch.uint8,
                           device=dev, generator=gen)
    inputs = {}

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

    @torch.inference_mode()
    def kernel_b():
        a1, k2 = inputs["l2"]
        out = stem_l2(a1, k2)
        err = compare_bf16(smoke, f"stem_l2 {tuple(a1.shape)} -> "
                           f"{tuple(out.shape)}", out, stem_l2_plain(a1, k2))
        smoke.stats["stem_l2"]["max_abs_err"] = err

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

    smoke.phase("2 kernel A", kernel_a)
    smoke.phase("3 kernel B", kernel_b)
    smoke.phase("4 NMS", kernel_nms)

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
        counts = kernels.launch_counts()
        for name, n in counts.items():
            smoke.stats[name]["launches"] = n
        smoke.check("launches", all(n == REQUESTS for n in counts.values()),
                    f"{counts} for {REQUESTS} requests")
        for i, d in enumerate(results):
            shapes = (tuple(d.boxes.shape), tuple(d.scores.shape),
                      tuple(d.valid.shape))
            finite = bool(torch.isfinite(d.boxes).all()
                          and torch.isfinite(d.scores).all())
            zero = bool((d.boxes[~d.valid] == 0).all()
                        and (d.scores[~d.valid] == 0).all())
            n_valid = d.valid.sum(1)
            smoke.check(f"request {i}", shapes == ((BATCH, 300, 4),
                                                   (BATCH, 300),
                                                   (BATCH, 300))
                        and finite and zero and bool((n_valid > 0).all()),
                        f"shapes {shapes} finite {finite} invalid-zero "
                        f"{zero} valid per image {n_valid.tolist()}")

        # the same batch, with the plain versions in place of the kernels
        x = requests[0]
        fast = detector_stem_fast_path(model)
        a_k = fast.stem(x)
        a_p = fused_stem_forward(x, dy0, dy1, temp, l1=stem_l1_plain,
                                 l2=stem_l2_plain)
        compare_bf16(smoke, f"stem output {tuple(a_p.shape)}", a_k, a_p)
        outs_k, outs_p = fast.tail(a_k), fast.tail(a_p)
        for h, (ok_, op_) in enumerate(zip(outs_k, outs_p)):
            for field in ("obj", "bbox"):
                g = getattr(ok_, field).float()
                w = getattr(op_, field).float()
                corr = float(torch.corrcoef(torch.stack(
                    [g.flatten(), w.flatten()]))[0, 1])
                err = float((g - w).abs().max())
                smoke.check(f"head {h} {field}", corr > 0.999,
                            f"max_abs_err {err:.4g} corr {corr:.6f}")
        scales = [SIZE // o.obj.shape[2] for o in outs_p]
        boxes, scores = decode_topk_global(outs_p, anchors, scales, 512)
        plain = select_detections(boxes, scores, 0.001, 0.5, 300,
                                  alive_fn=nms_alive_plain)
        d = results[0]
        nk, np_ = d.valid.sum(1), plain.valid.sum(1)
        m = int(torch.minimum(nk, np_).min())
        score_err = float((d.scores[:, :m] - plain.scores[:, :m]).abs().max())
        count_gap = int((nk - np_).abs().max())
        smoke.check("detections vs plain path",
                    score_err < 1e-3 and count_gap <= 0.05 * int(np_.max()),
                    f"valid {nk.tolist()} vs {np_.tolist()}; max |score "
                    f"diff| over the first {m} {score_err:.3g}")

    smoke.phase("5 main path", main_path)

    @torch.inference_mode()
    def timing():
        ms = cuda_ms(lambda: detect(frames))
        print(f"detector DyYOLO @{SIZE} bs={BATCH} uint8 -> Detections: "
              f"{ms:.3f} ms/batch, {BATCH * 1000.0 / ms:.1f} fps {tag}")
        pairs = {
            "stem_l1": (stem_l1, stem_l1_plain, inputs.get("l1")),
            "stem_l2": (stem_l2, stem_l2_plain, inputs.get("l2")),
            "nms": (nms_alive, nms_alive_plain,
                    (inputs["nms"], 0.5) if "nms" in inputs else None),
        }
        for name, (kern, plain, args) in pairs.items():
            if args is None:
                continue
            # alternate, so that neither side owns the card's warm state
            k1 = cuda_ms(lambda: kern(*args))
            p1 = cuda_ms(lambda: plain(*args))
            k2 = cuda_ms(lambda: kern(*args))
            p2 = cuda_ms(lambda: plain(*args))
            smoke.stats[name]["ms"] = min(k1, k2)
            smoke.stats[name]["plain_ms"] = min(p1, p2)
            print(f"{name}: kernel {k1:.4f} / {k2:.4f} ms, plain "
                  f"{p1:.4f} / {p2:.4f} ms {tag}")

    smoke.phase("6 timing", timing)

    @torch.inference_mode()
    def profile():
        """Device time by kernel over 3 batches, and the device's idle
        share."""
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile
        detect(frames)
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                detect(frames)
            end.record()
            end.synchronize()
        wall_us = start.elapsed_time(end) * 1e3
        from torch.autograd import DeviceType
        # kernels and copies on the card only (operator rows repeat them)
        rows = [(e.self_device_time_total, e.count, e.key)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        rows = sorted((r for r in rows if r[0] > 0), reverse=True)
        busy_us = sum(r[0] for r in rows)
        if not rows:
            print("profile: no device time recorded (not measured)")
            return
        print(f"profile: 3 batches, device busy {busy_us / 1e3:.3f} ms of "
              f"{wall_us / 1e3:.3f} ms, idle share "
              f"{1 - busy_us / wall_us:.3f} {tag}")
        for t, n, key in rows[:20]:
            print(f"  {t / 3e3:9.4f} ms/batch {n // 3:5d} calls/batch "
                  f"{key[:90]}")

    print("== 7 profile (informational)", flush=True)
    try:
        profile()
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
