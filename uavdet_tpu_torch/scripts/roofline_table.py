#!/usr/bin/env python3
"""The floor of each section of DyYOLO (and of DySOEM_SimFPN) on one H100.

Port of the analytic table ``scripts/roofline_table.py``: pure arithmetic,
no device. ``walk`` interprets DyYOLO's ``layer_config`` with the channel
and route semantics of ``models/interpreter.py`` and prices every conv,
upsample + concat and DyConv at its floor,

  floor = max(FLOPs / peak bf16 rate, bytes / memory rate),

where the bytes are the conv's bf16 input read once and its output written
once (weights are negligible at batch 16; BN, the activation and the
residual adds fuse into the conv's epilogue), and a DyConv is priced as the
plain conv of its mixed kernel (the expert mixing is O(E x out x in x k x k)
per image, negligible). A section's floor is the sum of its rows'. The
rows, their FLOPs and bytes are the JAX table's, row for row (a test holds
them equal); its lane-padded "achievable" column and ``--fold`` price the
TPU's 128-lane layout and are not ported.

The sections are the cuts of ``section_probe.py``: ``stem`` is the two
tokens of kernels A and B; ``early`` ends with the 256-channel stride-2
conv; ``mid`` with the 512-channel stride-2 conv; ``deep`` is the rest, the
heads included (``token_sections``).

``soem_walk`` prices DySOEM_SimFPN the same way, for the floors of the
sections of ``cfg3_section_probe.py``: ``front`` (the 1x1 input stem),
``soem_0`` to ``soem_2`` (each the 3x3 conv of its space-to-depth'd input,
kernel D's work) and ``neck+head`` (the neck's convs and the heads' 1x1 convs; its
adds and nearest upsamples fuse into their epilogues, as DyYOLO's residual
adds do). The decode, top-k and NMS of either detector have no floor here.

The peaks are the data sheet's for one H100 SXM at its 700 W limit, not
measurements: 989.4 TFLOP/s dense bf16 and 3.35 TB/s.

Usage: python3 -m uavdet_tpu_torch.scripts.roofline_table [--batch 16]
       [--size 640] [--per-layer]
"""

import argparse
from typing import NamedTuple

PEAK_BF16_FLOPS = 989.4e12   # H100 SXM data sheet, dense bf16
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet, HBM3

SECTIONS = ("stem", "early", "mid", "deep")
SOEM_SECTIONS = ("front", "soem_0", "soem_1", "soem_2", "neck+head")


class Row(NamedTuple):
    """One priced operation: its section, name, FLOPs, real bytes and the
    index of the token (DyYOLO) or step that runs it."""
    section: str
    name: str
    flops: float
    bytes: float
    token: int

    @property
    def floor_ms(self) -> float:
        return max(self.flops / PEAK_BF16_FLOPS,
                   self.bytes / HBM_BYTES_PER_S) * 1e3


def conv_cost(b, h, w, cin, cout, k, s):
    """(FLOPs, bytes) of one conv: its bf16 input read and its output
    written once."""
    ho, wo = h // s, w // s
    flops = 2.0 * b * ho * wo * cout * cin * k * k
    return flops, 2.0 * b * h * w * cin + 2.0 * b * ho * wo * cout


def token_sections(layer_config) -> list:
    """The section of each token of a DyYOLO ``layer_config``: ``stem``
    until the DyConv to 64 channels, which is its last token; then
    ``early`` through the plain conv to 256 channels at stride 2, ``mid``
    through the one to 512 at stride 2, ``deep`` after it. The JAX walk's
    labels, token by token."""
    sec, out = "stem", []
    for tok in layer_config:
        out.append(sec)
        if tok[0] == "DyConv":
            if sec == "stem" and tok[1] == 64:
                sec = "early"
        elif tok[0] not in ("B", "S", "U"):
            out_c, _, s = tok
            if out_c == 256 and s == 2:
                sec = "mid"
            elif out_c == 512 and s == 2:
                sec = "deep"
    return out


def walk(b: int, size: int, layer_config=None) -> list:
    """The priced rows of DyYOLO (``models.registry.DYYOLO``'s
    ``layer_config`` unless another is given) on (b, size, size, 3)
    frames, in the interpreter's order."""
    if layer_config is None:
        from ..models.registry import DYYOLO
        layer_config = DYYOLO.layer_config
    labels = token_sections(layer_config)
    h = w = size
    c = 3
    routes, rows = [], []

    def res_block(idx, h, w, c, n):
        for i in range(n):
            rows.append(Row(labels[idx], f"res{c}@{h}.{i}a 1x1 {c}->{c//2}",
                            *conv_cost(b, h, w, c, c // 2, 1, 1), idx))
            rows.append(Row(labels[idx], f"res{c}@{h}.{i}b 3x3 {c//2}->{c}",
                            *conv_cost(b, h, w, c // 2, c, 3, 1), idx))

    n_scale = 0
    for idx, tok in enumerate(layer_config):
        sec = labels[idx]
        if tok[0] == "B":
            res_block(idx, h, w, c, tok[1])
            if tok[1] == 8:
                routes.append(c)
        elif tok[0] == "S":
            n_scale += 1
            res_block(idx, h, w, c, 1)
            rows.append(Row(sec, f"S{n_scale} 1x1 {c}->{c//2}@{h}",
                            *conv_cost(b, h, w, c, c // 2, 1, 1), idx))
            rows.append(Row(sec, f"S{n_scale} pred 3x3 {c//2}->{c}@{h}",
                            *conv_cost(b, h, w, c // 2, c, 3, 1), idx))
            c = c // 2
        elif tok[0] == "U":
            h, w = h * 2, w * 2
            rc = routes.pop()
            # upsample + concat: data movement only, the output written
            # once and the inputs read once
            _, br = conv_cost(b, h, w, c + rc, 1, 1, 1)
            rows.append(Row(sec, f"U+concat -> {c+rc}@{h}", 0.0,
                            br - 2.0 * b * h * w, idx))
            c = c + rc
        elif tok[0] == "DyConv":
            out_c, k, s = tok[1:]
            rows.append(Row(sec, f"DyConv {k}x{k} {c}->{out_c}@{h}s{s}",
                            *conv_cost(b, h, w, c, out_c, k, s), idx))
            h, w, c = h // s, w // s, out_c
        else:
            out_c, k, s = tok
            rows.append(Row(sec, f"conv {k}x{k} {c}->{out_c}@{h}s{s}",
                            *conv_cost(b, h, w, c, out_c, k, s), idx))
            h, w, c = h // s, w // s, out_c
    return rows


def soem_walk(b: int, size: int) -> list:
    """The priced rows of DySOEM_SimFPN (``models/dysoem_simfpn.py`` at
    ``models.registry.DYSOEM``'s widths: a 32-channel stem, three SOEMs,
    three anchors a head) on (b, size, size, 3) frames; ``token`` is the
    step: 0 the front, 1 to 3 the SOEMs, 4 the neck and heads."""
    rows = [Row("front", f"stem 1x1 3->32@{size}",
                *conv_cost(b, size, size, 3, 32, 1, 1), 0)]
    h, c = size, 32
    maps = []
    for i in range(3):
        h, cin = h // 2, 4 * c
        c = cin // 2
        rows.append(Row(f"soem_{i}", f"soem_{i} 3x3 {cin}->{c}@{h}",
                        *conv_cost(b, h, h, cin, c, 3, 1), i + 1))
        maps.append((h, c))
    (h0, c0), (h1, c1), (h2, c2) = maps
    step = 4
    for name, hh, ci, co, k, s in (
            ("x2_in_down 1x1", h2, c2, c1, 1, 1),
            ("center_down 1x1", h1, c1, c0, 1, 1),
            ("x0_out_up 1x1 s2", h0, c0, c1, 1, 2),
            ("x1_out_up 1x1 s2", h1, c1, c2, 1, 2),
            ("x0_conv_out 3x3", h0, c0, c0, 3, 1),
            ("x1_conv_out 3x3", h1, c1, c1, 3, 1),
            ("x2_conv_out 3x3", h2, c2, c2, 3, 1)):
        rows.append(Row("neck+head", f"{name} {ci}->{co}@{hh}",
                        *conv_cost(b, hh, hh, ci, co, k, s), step))
    for i, (hh, cc) in enumerate(maps):
        # the objectness and box 1x1 convs read the map once together
        out = 3 * 5
        rows.append(Row("neck+head", f"head {i} 1x1 {cc}->{out}@{hh}",
                        *conv_cost(b, hh, hh, cc, out, 1, 1), step))
    return rows


def totals(rows) -> dict:
    """{section: {"gflop", "gb", "floor_ms"}} in the rows' order."""
    out = {}
    for r in rows:
        t = out.setdefault(r.section, {"gflop": 0.0, "gb": 0.0,
                                       "floor_ms": 0.0})
        t["gflop"] += r.flops / 1e9
        t["gb"] += r.bytes / 1e9
        t["floor_ms"] += r.floor_ms
    return out


def section_floors(batch: int, size: int, layer_config=None) -> dict:
    """{section: floor ms} of DyYOLO at (batch, size)."""
    return {sec: t["floor_ms"] for sec, t in
            totals(walk(batch, size, layer_config)).items()}


def soem_section_floors(batch: int, size: int) -> dict:
    """{section: floor ms} of DySOEM_SimFPN at (batch, size)."""
    return {sec: t["floor_ms"] for sec, t in
            totals(soem_walk(batch, size)).items()}


def main(argv=None) -> dict:
    """Prints DyYOLO's table; -> {"sections": totals, "total": {...},
    "floor_fps": forward-only frames per second at the floor}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--per-layer", action="store_true")
    args = ap.parse_args(argv)
    rows = walk(args.batch, args.size)
    if args.per_layer:
        for r in rows:
            print(f"{r.section:9s} {r.name:36s} "
                  f"{r.flops / PEAK_BF16_FLOPS * 1e3:8.3f} ms by FLOPs "
                  f"{r.bytes / HBM_BYTES_PER_S * 1e3:8.3f} ms by bytes "
                  f"floor {r.floor_ms:8.3f} ms")
    secs = totals(rows)
    total = {k: sum(t[k] for t in secs.values())
             for k in ("gflop", "gb", "floor_ms")}
    print(f"DyYOLO batch {args.batch} at {args.size} px; H100 SXM "
          f"data sheet: {PEAK_BF16_FLOPS / 1e12:.1f} TFLOP/s bf16, "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    print(f"{'section':10s} {'GFLOP':>9s} {'GB':>8s} {'floor ms':>9s}")
    for sec, t in list(secs.items()) + [("total", total)]:
        print(f"{sec:10s} {t['gflop']:9.1f} {t['gb']:8.3f} "
              f"{t['floor_ms']:9.3f}")
    fps = args.batch / total["floor_ms"] * 1e3
    print(f"forward-only floor: {fps:.1f} frames/s")
    return {"sections": secs, "total": total, "floor_fps": fps}


if __name__ == "__main__":
    main()
