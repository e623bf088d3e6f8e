#!/usr/bin/env python3
"""What holds kernel A (``csrc/stem_l1.cu``), the NMS kernel
(``csrc/nms.cu``) and kernel G (``csrc/post_stem_block.cu``), measured on
variants of them, on one NVIDIA GPU.

A variant is a copy of ``csrc/`` in a temporary directory with a few pieces
of text replaced (``A_VARIANTS``, ``C_VARIANTS``, ``G_VARIANTS``: file, old
text, new text),
built by nvcc into a library of its own and launched through its C entry
point; the shipped library is not touched. A CPU test holds every ``old``
text against the sources, so a variant cannot silently stop applying.
Times are the mean of launches launched back to back between two CUDA
events; the first line printed is the card's name and power limit.

Kernel A at (batch, input, input, 3) uint8, each variant held against the
plain version:

  base        the kernel as shipped
  storeonly   the same stores, no product, SiLU or sums: the write's floor
  nosilu      no SiLU (wrong values): what the special-function unit costs
  nosums      no channel sums
  stcs        streaming stores (st.global.cs)
  blocks4/8   4 or 8 resident blocks per SM asked for instead of 6
  rows8/32    block tiles of 8 or 32 rows instead of 16
  cols32/128  block tiles of 32 or 128 columns instead of 64
  tanh        SiLU as h + h tanh.approx(h), h = v / 2: one MUFU, not two
  and a memset of the output, the card's own floor for the write.

The NMS kernel at (batch, 512) and (1, 512), at most 512 boxes so that
every cluster size fits the static shared memory: clusters of 2, 4 or 8
blocks of 256, 512 or 1024 threads; per variant the kernel and an empty
launch of its grid, one launch between two events and back to back, and
the two phases by the card's global timer. With ``--parent-csrc DIR``
(the ``csrc/`` of a checkout of the one-block-per-image kernel that
preceded this one) that kernel's two phases are read the same way.

Kernel G at (batch, input / 2, input / 2, 64), every stage of its ladder
by one launch between two events, ``full`` also back to back, held against
the plain version:

  base        the kernel as shipped
  sets2/4     2 or 4 sets of A fragments in its convs instead of 3
  noremote    no stores of the sums into the other block (wrong values)
  noexchange  neither those stores nor the waits for them
  nostore     no TMA store of the output tiles (nothing written)

Usage: python3 -m uavdet_tpu_torch.scripts.kernel_probe [--only a,c,g]
       [--batch 16] [--input 640] [--iters 20] [--parent-csrc DIR]
"""

import argparse
import ctypes
import shutil
import statistics
import subprocess
import tempfile
from pathlib import Path

L1, TILE, NMS = "stem_l1.cu", "stem_l1_tile.cuh", "nms.cu"
PSB = "post_stem_block.cu"
_BOUNDS = "__launch_bounds__(THREADS, 6)"
_SILU = ("pack_bf16x2(silu_fast(acc[j][0]), silu_fast(acc[j][1]))",
         "pack_bf16x2(silu_fast(acc[j][2]), silu_fast(acc[j][3]))")
_NO_SUMS = [(L1, "        add_stored(sum, lo);\n", ""),
            (L1, "        add_stored(sum, hi);\n", "")]

A_VARIANTS = {
    "base": [],
    "storeonly": [
        (L1, "      tile_mma(p, p + 8, PITCH, bf, acc);\n      uint4 lo, hi;\n"
             "      activate(acc, lo, hi);\n",
         "      uint4 lo = make_uint4(p[0].x, bf[0][0][0], ty, lane);\n"
         "      uint4 hi = make_uint4(p[8].y, bf[1][1][1], ty, g);\n"),
        *_NO_SUMS],
    "nosilu": [(TILE, s, s.replace("silu_fast", "")) for s in _SILU],
    "nosums": _NO_SUMS,
    "stcs": [
        (L1, "        *reinterpret_cast<uint4*>(dst) = lo;\n",
         "        __stcs(reinterpret_cast<uint4*>(dst), lo);\n"),
        (L1, "        *reinterpret_cast<uint4*>(dst + 8 * C_OUT) = hi;\n",
         "        __stcs(reinterpret_cast<uint4*>(dst + 8 * C_OUT), hi);\n")],
    "blocks4": [(L1, _BOUNDS, "__launch_bounds__(THREADS, 4)")],
    "blocks8": [(L1, _BOUNDS, "__launch_bounds__(THREADS, 8)")],
    "rows8": [(L1, "constexpr int TH = 16;", "constexpr int TH = 8;")],
    "rows32": [(L1, "constexpr int TH = 16;", "constexpr int TH = 32;")],
    "cols32": [(L1, "constexpr int TW = 64;", "constexpr int TW = 32;"),
               (L1, _BOUNDS, "__launch_bounds__(THREADS, 12)")],
    "cols128": [(L1, "constexpr int TW = 64;", "constexpr int TW = 128;"),
                (L1, _BOUNDS, "__launch_bounds__(THREADS, 3)")],
    "tanh": [*((TILE, s, s.replace("silu_fast", "silu_tanh")) for s in _SILU),
             (TILE, "namespace l1 {\n",
              "namespace l1 {\n__device__ __forceinline__ float "
              "silu_tanh(float v) {\n  float h = 0.5f * v, t;\n"
              '  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(h));\n'
              "  return fmaf(h, t, h);\n}\n")],
}

_SMALL = (NMS, "constexpr int MAX_N = 1024;", "constexpr int MAX_N = 512; ")
C_VARIANTS = {
    f"cluster{c}_threads{t}": [
        _SMALL,
        (NMS, "constexpr int CLUSTER = 8;", f"constexpr int CLUSTER = {c};"),
        (NMS, "constexpr int THREADS = 512;", f"constexpr int THREADS = {t};"),
        (NMS, "__launch_bounds__(THREADS, 2)",
         f"__launch_bounds__(THREADS, {2 if t <= 512 else 1})")]
    for c in (2, 4, 8) for t in (256, 512, 1024)}

# the global timer read after each phase of the kernel that preceded this one
_STAMP = ('{ long long t; asm volatile("mov.u64 %0, %%globaltimer;" : '
          '"=l"(t)); stamps[3 * blockIdx.x + N] = t; }')
PARENT_NMS_STAMPS = [
    (NMS, "uint8_t* __restrict__ alive, int N, float thr) {",
     "uint8_t* __restrict__ alive, int N, float thr, long long* stamps) {\n"
     "  if (threadIdx.x == 0) " + _STAMP.replace("+ N", "+ 0")),
    (NMS, "  __syncthreads();\n\n  if (tid < 32) {",
     "  __syncthreads();\n  if (tid == 0) " + _STAMP.replace("+ N", "+ 1")
     + "\n  if (tid < 32) {"),
    (NMS, "      if (tid == 0) out[i] = keep ? 1 : 0;\n    }\n",
     "      if (tid == 0) out[i] = keep ? 1 : 0;\n    }\n    if (tid == 0) "
     + _STAMP.replace("+ N", "+ 2") + "\n"),
    (NMS, "float thr,\n                                   void* stream) {",
     "float thr,\n                                   void* stream, "
     "void* stamps) {"),
    (NMS, "static_cast<uint8_t*>(alive), N, thr);",
     "static_cast<uint8_t*>(alive), N, thr, "
     "static_cast<long long*>(stamps));"),
]

# kernel G: fragment sets in flight, and what the exchange of the output
# conv's sums between the two blocks and the tiles' stores cost (those
# variants give wrong outputs: timing only; a block still leaves only when
# the other is done with its shared memory)
G_VARIANTS = {
    "base": [],
    "sets2": [(PSB, "constexpr int SETS = 3;", "constexpr int SETS = 2;")],
    "sets4": [(PSB, "constexpr int SETS = 3;", "constexpr int SETS = 4;")],
    "noremote": [(PSB, "st_cluster_v4(peer_part",
                  "if (false) st_cluster_v4(peer_part")],
    "noexchange": [(PSB, "st_cluster_v4(peer_part",
                    "if (false) st_cluster_v4(peer_part"),
                   (PSB, "mbar_wait_cluster(sums_",
                    "if (false) mbar_wait_cluster(sums_")],
    "nostore": [(PSB, "tma_store_4d(&out_map, s_base + OFF_OUT, rank * C0, "
                 "ox0, oy0, b);", "")],
}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def substitute(csrc: Path, subs, into: Path) -> None:
    """A copy of ``csrc`` in ``into`` with ``subs`` applied; a text that is
    not there raises."""
    shutil.copytree(csrc, into)
    for name, old, new in subs:
        text = (into / name).read_text()
        if old not in text:
            raise ValueError(f"{name}: text to replace not found: {old!r}")
        (into / name).write_text(text.replace(old, new))


def build_variants(variants: dict, source: str, csrc: Path, tmp: Path):
    """-> {name: ctypes library}, one nvcc per variant, all at once; a
    variant that does not build is reported and left out."""
    from .. import kernels
    nvcc = kernels._nvcc()
    procs = {}
    for name, subs in variants.items():
        substitute(csrc, subs, tmp / name)
        procs[name] = subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-shared", "-o",
             str(tmp / name / "lib.so"), str(tmp / name / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            print(f"{name}: nvcc failed\n{log[-2000:]}", flush=True)
            continue
        regs = sorted({line.split("Used ")[1].split(",")[0]
                       for line in log.splitlines() if "Used " in line})
        print(f"built {name}: {', '.join(regs)}", flush=True)
        libs[name] = ctypes.CDLL(str(tmp / name / "lib.so"))
    return libs


def checked(fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"CUDA error {err}")


def probe_a(args, tmp: Path) -> None:
    import torch

    from .. import kernels
    from ..ops.stem import stem_l1_plain
    from ..utils.timing import back_to_back_ms
    libs = build_variants(A_VARIANTS, L1, kernels.CSRC, tmp)
    rng = torch.Generator(device="cuda").manual_seed(0)
    b, s = args.batch, args.input
    x = torch.randint(0, 256, (b, s, s, 3), dtype=torch.uint8, device="cuda",
                      generator=rng)
    k1 = 0.2 * torch.randn((b, 32, 28), generator=rng, device="cuda")
    k1[..., :27] /= 255.0
    kq = k1.to(torch.bfloat16).contiguous()
    want, _ = stem_l1_plain(x, k1)
    out = torch.empty_like(want)
    stream = torch.cuda.current_stream().cuda_stream
    for name, lib in libs.items():
        lib.uavdet_stem_l1.argtypes = [_P, _I, _P, _P, _P, _I, _I, _I, _P]
        partial = torch.empty((b, lib.uavdet_stem_l1_num_partials(s, s), 32),
                              device="cuda")

        def run():
            checked(lib.uavdet_stem_l1, x.data_ptr(), 1, kq.data_ptr(),
                    out.data_ptr(), partial.data_ptr(), b, s, s, stream)
        ms = [back_to_back_ms(run, args.iters) for _ in range(2)]
        torch.cuda.synchronize()
        close = torch.allclose(out.float(), want.float(), rtol=1.6e-2,
                               atol=1e-2)
        print(f"A {name:<10s} {ms[0]:.4f} / {ms[1]:.4f} ms; within the "
              f"tolerance of the plain version: {close}; bitwise equal "
              f"{float((out == want).float().mean()):.5f}", flush=True)
    ms = back_to_back_ms(out.zero_, args.iters)
    print(f"A memset of the output ({out.numel() * 2 / 1e6:.0f} MB): "
          f"{ms:.4f} ms", flush=True)


def nms_boxes(batch: int, n: int):
    """Score-sorted crowded boxes, as the smoke test's case."""
    import numpy as np
    import torch

    from ..ops.nms import nms_edge_case
    boxes, scores = nms_edge_case("crowded", batch, n,
                                  np.random.default_rng(0))
    order = np.argsort(-scores, axis=1, kind="stable")
    return torch.from_numpy(np.take_along_axis(
        boxes, order[..., None], axis=1)).cuda().contiguous()


def phase_us(launch, stamps) -> list:
    """Medians over 5 launches of (first phase, second phase, first start to
    last end) in us, from (B, 3) global-timer stamps."""
    import torch
    rows = []
    for _ in range(5):
        launch()
        torch.cuda.synchronize()
        t = stamps.cpu()
        rows.append((float((t[:, 1] - t[:, 0]).max()) * 1e-3,
                     float((t[:, 2] - t[:, 1]).max()) * 1e-3,
                     float(t[:, 2].max() - t[:, 0].min()) * 1e-3))
    return [statistics.median(v) for v in zip(*rows)]


def probe_c(args, tmp: Path) -> None:
    import torch

    from .. import kernels
    from ..ops.nms import nms_alive_plain
    from ..utils.timing import back_to_back_ms, cuda_ms
    libs = build_variants(C_VARIANTS, NMS, kernels.CSRC, tmp)
    stream = torch.cuda.current_stream().cuda_stream
    print(f"two events with nothing between them: "
          f"{cuda_ms(lambda: None, args.iters, 3):.4f} ms", flush=True)
    for batch in (args.batch, 1):
        boxes = nms_boxes(batch, 512)
        want = nms_alive_plain(boxes, 0.5)
        alive = torch.empty_like(want)
        stamps = torch.zeros((batch, 3), dtype=torch.int64, device="cuda")
        for name, lib in libs.items():
            lib.uavdet_nms_alive.argtypes = [_P, _P, _I, _I, _F, _P]
            lib.uavdet_nms_alive_stamped.argtypes = [_P, _P, _P, _I, _I, _F,
                                                     _P]
            lib.uavdet_nms_empty_launch.argtypes = [_I, _P]

            def run():
                checked(lib.uavdet_nms_alive, boxes.data_ptr(),
                        alive.data_ptr(), batch, 512, 0.5, stream)

            def empty():
                checked(lib.uavdet_nms_empty_launch, batch, stream)

            def stamped():
                checked(lib.uavdet_nms_alive_stamped, boxes.data_ptr(),
                        alive.data_ptr(), stamps.data_ptr(), batch, 512, 0.5,
                        stream)
            one, burst = cuda_ms(run, args.iters, 3), back_to_back_ms(run, 200)
            torch.cuda.synchronize()
            mask, walk, span = phase_us(stamped, stamps)
            print(f"C {name} ({batch}, 512): {one:.4f} ms, back to back "
                  f"{burst:.4f}; empty launch {cuda_ms(empty, args.iters, 3):.4f}"
                  f", back to back {back_to_back_ms(empty, 200):.4f}; pair "
                  f"mask {mask:.1f} us, walk {walk:.1f}, first start to last "
                  f"end {span:.1f}; differs from the plain version in "
                  f"{int((alive != want).sum())}", flush=True)


def probe_parent_nms(args, tmp: Path) -> None:
    import torch
    libs = build_variants({"parent_nms": PARENT_NMS_STAMPS}, NMS,
                          Path(args.parent_csrc), tmp)
    fn = libs["parent_nms"].uavdet_nms_alive
    fn.argtypes = [_P, _P, _I, _I, _F, _P, _P]
    stream = torch.cuda.current_stream().cuda_stream
    for batch in (args.batch, 1):
        boxes = nms_boxes(batch, 512)
        alive = torch.empty((batch, 512), dtype=torch.bool, device="cuda")
        stamps = torch.zeros((batch, 3), dtype=torch.int64, device="cuda")
        mask, walk, span = phase_us(
            lambda: checked(fn, boxes.data_ptr(), alive.data_ptr(), batch,
                            512, 0.5, stream, stamps.data_ptr()), stamps)
        print(f"C the kernel before ({batch}, 512): pair mask {mask:.1f} us, "
              f"walk {walk:.1f}, first start to last end {span:.1f}",
              flush=True)


def probe_g(args, tmp: Path) -> None:
    """Kernel G's variants at the block's shape in DyYOLO, each stage of
    the ladder, on weights packed once."""
    import torch

    from .. import kernels
    from ..ops.block import (BLOCK_STAGES, pack_block_weights,
                             post_stem_block_plain)
    from ..utils.timing import back_to_back_ms, cuda_ms
    libs = build_variants(G_VARIANTS, PSB, kernels.CSRC, tmp)
    rng = torch.Generator(device="cuda").manual_seed(0)
    b, h = args.batch, args.input // 2
    x = torch.randn((b, h, h, 64), generator=rng, device="cuda").to(
        torch.bfloat16)
    ws = [0.1 * torch.randn(s, generator=rng, device="cuda")
          for s in ((32, 65), (64, 289), (128, 577))]
    want = post_stem_block_plain(x, *ws)
    (i1, c1, _), (i2, c2, _), (i3, c3, _) = pack_block_weights(*ws)
    out = torch.empty_like(want)
    stream = torch.cuda.current_stream().cuda_stream
    for name, lib in libs.items():
        lib.uavdet_post_stem_block.argtypes = [_P] * 8 + [_I] * 4 + [_P]
        times = []
        for stage in range(len(BLOCK_STAGES)):
            def run():
                checked(lib.uavdet_post_stem_block, x.data_ptr(),
                        i1.data_ptr(), i2.data_ptr(), i3.data_ptr(),
                        c1.data_ptr(), c2.data_ptr(), c3.data_ptr(),
                        out.data_ptr(), b, h, h, stage, stream)
            times.append(cuda_ms(run, args.iters, 3))
        burst = back_to_back_ms(run, args.iters)
        torch.cuda.synchronize()
        close = torch.allclose(out.float(), want.float(), rtol=1.6e-2,
                               atol=1e-2)
        print(f"G {name:<10s} " + " / ".join(
            f"{s} {t:.4f}" for s, t in zip(BLOCK_STAGES, times))
            + f" ms; full back to back {burst:.4f}; within the tolerance of "
            f"the plain version: {close}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", type=str, default="a,c",
                    help="comma list of a (kernel A), c (the NMS kernel), "
                         "g (kernel G)")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--input", type=int, default=640)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--parent-csrc", type=str, default="",
                    help="csrc/ of a checkout of the NMS kernel before this "
                         "one: its two phases are timed too")
    args = ap.parse_args(argv)

    import torch

    from ..utils.timing import card_line

    if not torch.cuda.is_available():
        raise SystemExit("kernel_probe needs a CUDA device; none is visible")
    print(card_line(), flush=True)
    torch.backends.cudnn.allow_tf32 = False   # the plain version stays f32
    only = {p.strip() for p in args.only.split(",")}
    with tempfile.TemporaryDirectory() as tmp:
        if "a" in only:
            probe_a(args, Path(tmp) / "a")
        if "g" in only:
            probe_g(args, Path(tmp) / "g")
        if "c" in only:
            probe_c(args, Path(tmp) / "c")
            if args.parent_csrc:
                probe_parent_nms(args, Path(tmp) / "parent")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
