"""One priced conv: its FLOPs, and its bf16 input read once and its output
written once."""

from typing import NamedTuple


class Row(NamedTuple):
    section: str
    name: str
    flops: float
    bytes: float
    token: int


def conv_cost(b, h, w, cin, cout, k, s):
    ho, wo = h // s, w // s
    flops = 2.0 * b * ho * wo * cout * cin * k * k
    return flops, 2.0 * b * h * w * cin + 2.0 * b * ho * wo * cout
