"""DySOEM_SimFPN's convs priced at their shapes: a frozen copy of the port's
``scripts/roofline_table.py:soem_walk`` (a test holds the two equal), for a
32-channel stem, SOEMs of 3x3 experts and three anchors a head."""

from .common import Row, conv_cost


def rows(b: int, size: int, hparams: dict) -> list:
    out = [Row("front", f"stem 1x1 3->32@{size}",
               *conv_cost(b, size, size, 3, 32, 1, 1), 0)]
    h, c = size, 32
    maps = []
    for i in range(len(hparams["num_dy_conv"])):
        h, cin = h // 2, 4 * c
        c = cin // 2
        out.append(Row(f"soem_{i}", f"soem_{i} 3x3 {cin}->{c}@{h}",
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
        out.append(Row("neck+head", f"{name} {ci}->{co}@{hh}",
                       *conv_cost(b, hh, hh, ci, co, k, s), step))
    n_out = 5 * len(hparams["anchors"][0])
    for i, (hh, cc) in enumerate(maps):
        out.append(Row("neck+head", f"head {i} 1x1 {cc}->{n_out}@{hh}",
                       *conv_cost(b, hh, hh, cc, n_out, 1, 1), step))
    return out
