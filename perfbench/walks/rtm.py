"""RTMUAVDet priced at its shapes: every conv, every linear layer and each
per-sample spatial filter (k x k over every channel of its sample; a 1x1
filter is one product a value) of ``reference/rtm_uav_det.py``. The 2x
bilinear upsample is priced as data movement alone; norms, activations and
adds are left out. A linear layer's input and output are priced as a conv's
at one pixel."""

from .common import Row, conv_cost


def out_size(h: int, k: int, s: int, p: int) -> int:
    return (h + 2 * p - k) // s + 1


def rows(b: int, size: int, hparams: dict) -> list:
    out = []

    def conv(section, name, h, cin, cout, k=1, s=1, p=0):
        ho = out_size(h, k, s, p)
        flops = 2.0 * b * ho * ho * cout * cin * k * k
        out.append(Row(section, f"{name} {k}x{k} {cin}->{cout}@{h}s{s}",
                       flops, 2.0 * b * (h * h * cin + ho * ho * cout),
                       len(out)))
        return ho

    def linear(section, name, cin, cout):
        out.append(Row(section, f"{name} linear {cin}->{cout}",
                       *conv_cost(b, 1, 1, cin, cout, 1, 1), len(out)))

    def mdy(section, name, h, cin, c, k):
        conv(section, f"{name}.base", h, cin, c)
        linear(section, f"{name}.attention", c, 16)
        linear(section, f"{name}.channel_fc", 16, c)
        linear(section, f"{name}.kernel_fc", 16, k * k)
        out.append(Row(section, f"{name}.filter {k}x{k} x{c}@{h}",
                       2.0 * b * h * h * c * k * k, 4.0 * b * h * h * c,
                       len(out)))

    def csp(name, h, cin, cout, dy=None):
        half = cin
        h = conv("csp", f"{name}.base_conv", h, cin, 2 * cin, 3, 2, 1)
        conv("csp", f"{name}.conv1", h, 2 * cin, half)
        conv("csp", f"{name}.conv2", h, 2 * cin, half)
        mdy("csp", f"{name}.mdy_conv", h, half, dy or half, 3)
        conv("csp", f"{name}.transition1", h, dy or half, half)
        conv("csp", f"{name}.transition2", h, 2 * half, cout, 3, 1, 1)
        return h

    def encoder(name, h, cin, cout):
        third = cin // 3
        for k in (1, 3, 5):
            mdy("mdy", f"{name}.mdy_conv_{k}x{k}", h, cin, third, k)
        conv("mlp", f"{name}.mlp_fc1", h, 3 * third, cin)
        conv("mlp", f"{name}.mlp_fc2", h, cin, cout)

    h = conv("stem", "stem", size, 3, 32, 5, 2, 1)
    h1 = csp("MDyCSP_1", h, 32, 128, dy=128)
    h2 = csp("MDyCSP_2", h1, 128, 256)
    out.append(Row("fuse", f"upsample 2x 256@{h2}", 0.0,
                   2.0 * b * 256 * (h2 * h2 + 4 * h2 * h2), len(out)))
    conv("fuse", "neck.upsample_conv", 2 * h2, 256, 64, 3, 1, 1)
    encoder("neck.encoder_x1", h1, 128 + 64, 128)
    conv("fuse", "neck.downsample", h1, 128, 128, 3, 2, 1)
    encoder("neck.encoder_x2", h2, 256 + 128, 256)
    a = len(hparams["anchors"][0])
    for i, (hh, c) in enumerate(((h1, 128), (h2, 256))):
        conv("head", f"head.obj_{i}", hh, c, a)
        conv("head", f"head.bbox_{i}", hh, c, 4 * a)
    return out
