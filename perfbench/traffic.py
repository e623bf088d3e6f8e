"""The one generator of the benchmark's inputs: it reads a traffic mix
(``traffic/<name>.json``) and makes that mix's inputs from the seed on the
device. Every seed gives the same sizes; the seed changes the content.

Frames (a mix's ``frames``): per frame a base level drawn uniformly from
``level``, a noise amplitude from ``noise`` and uniform noise around the
base, on ``channels`` channels (1: a thermal camera's grey frame, repeated
on the three channels that the detector takes), and one square target of
side drawn from ``target_px`` pixels at ``target_level``, placed uniformly.
"""

import torch


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for stream ``stream`` of seed ``seed``."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + stream) % (2 ** 63))


def frames(n: int, size: int, p: dict, gen, device) -> torch.Tensor:
    """(n, size, size, 3) uint8 frames made by the parameters ``p``."""
    u = torch.rand((n, 4), generator=gen, device=device)
    lo_level, hi_level = p["level"]
    lo_noise, hi_noise = p["noise"]
    lo_px, hi_px = p["target_px"]
    base = lo_level + (hi_level - lo_level) * u[:, 0]
    amp = lo_noise + (hi_noise - lo_noise) * u[:, 1]
    side = (lo_px + (hi_px - lo_px) * u[:, 2]).round()
    lo = ((size - side)[:, None] * torch.rand((n, 2), generator=gen,
                                              device=device)).floor()
    boxes = torch.cat([lo, lo + side[:, None]], dim=1)
    noise = torch.rand((n, size, size, p["channels"]), generator=gen,
                       device=device) * 2 - 1
    x = base[:, None, None, None] + amp[:, None, None, None] * noise
    yy = torch.arange(size, device=device)[None, :, None]
    xx = torch.arange(size, device=device)[None, None, :]
    inside = ((yy >= boxes[:, 1, None, None]) & (yy < boxes[:, 3, None, None])
              & (xx >= boxes[:, 0, None, None])
              & (xx < boxes[:, 2, None, None]))
    x = torch.where(inside[..., None], float(p["target_level"]), x)
    out = x.clamp(0, 255).to(torch.uint8)
    return out.expand(n, size, size, 3).contiguous()


def detect_inputs(traffic: dict, seed: int, device) -> list:
    """The mix's ``distinct`` batches of (batch, size, size, 3) uint8
    frames."""
    gen = generator(seed, 1, device)
    return [frames(traffic["batch"], traffic["size"], traffic["frames"], gen,
                   device) for _ in range(traffic["distinct"])]
