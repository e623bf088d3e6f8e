"""DyYOLO's convs priced at their shapes: a frozen copy of the port's
``scripts/roofline_table.py:walk`` (a test holds the two equal). A DyConv is
priced as the plain conv of its mixed kernel; an upsample and concat as
data movement alone; the heads' 1x1 convs are left out, as there."""

from .common import Row, conv_cost


def token_sections(layer_config) -> list:
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


def rows(b: int, size: int, hparams: dict) -> list:
    layer_config = [tuple(t) for t in hparams["layer_config"]]
    labels = token_sections(layer_config)
    h = w = size
    c = 3
    routes, out = [], []

    def res_block(idx, h, w, c, n):
        for i in range(n):
            out.append(Row(labels[idx], f"res{c}@{h}.{i}a 1x1 {c}->{c//2}",
                           *conv_cost(b, h, w, c, c // 2, 1, 1), idx))
            out.append(Row(labels[idx], f"res{c}@{h}.{i}b 3x3 {c//2}->{c}",
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
            out.append(Row(sec, f"S{n_scale} 1x1 {c}->{c//2}@{h}",
                           *conv_cost(b, h, w, c, c // 2, 1, 1), idx))
            out.append(Row(sec, f"S{n_scale} pred 3x3 {c//2}->{c}@{h}",
                           *conv_cost(b, h, w, c // 2, c, 3, 1), idx))
            c = c // 2
        elif tok[0] == "U":
            h, w = h * 2, w * 2
            rc = routes.pop()
            _, br = conv_cost(b, h, w, c + rc, 1, 1, 1)
            out.append(Row(sec, f"U+concat -> {c+rc}@{h}", 0.0,
                           br - 2.0 * b * h * w, idx))
            c = c + rc
        elif tok[0] == "DyConv":
            out_c, k, s = tok[1:]
            out.append(Row(sec, f"DyConv {k}x{k} {c}->{out_c}@{h}s{s}",
                           *conv_cost(b, h, w, c, out_c, k, s), idx))
            h, w, c = h // s, w // s, out_c
        else:
            out_c, k, s = tok
            out.append(Row(sec, f"conv {k}x{k} {c}->{out_c}@{h}s{s}",
                           *conv_cost(b, h, w, c, out_c, k, s), idx))
            h, w, c = h // s, w // s, out_c
    return out
