"""What the kinds of traffic mix share, and where each is found by name.

A traffic mix (``traffic/<mix>.json``) names its kind (``"kind"``); the
module ``kinds/<kind>.py`` holds the ``Cell`` class that drives it. A
configuration names its program entry (``"entry"``, ``entries/<entry>.py``)
and its plain reference (``"reference"``, ``reference/<reference>.py``).

A cell's object is built once per run. ``setup`` makes the weights and
inputs from the seed, builds the program and warms up every shape the mix
uses; ``window`` drives the mix for a number of seconds, keeps a sample of
its answers (drawn from the seed) and returns its readings (``attempted``,
``wall_s``, and what the end-to-end metrics' readers read); ``issue`` is
one call into the program's entry; ``run_one`` one call as the window makes
it; ``free`` drops the program's state; ``check`` runs the reference and
returns the numbers that decide ``correct``; ``control`` the same numbers
of the reference in float8 in the program's place.
"""

import contextlib
import importlib
import random

import torch


def cell_class(kind: str):
    """``kinds/<kind>.py``'s ``Cell``."""
    return importlib.import_module(f"perfbench.kinds.{kind}").Cell


def entry(name: str):
    """The module ``entries/<name>.py``."""
    return importlib.import_module(f"perfbench.entries.{name}")


def reference_model(config: dict, device) -> torch.nn.Module:
    """The configuration's plain reference (``reference/<name>.py``)."""
    mod = importlib.import_module(f"perfbench.reference.{config['reference']}")
    with torch.device(device):
        return mod.build(config["hparams"])


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def reference_precision():
    """Float32 products everywhere inside: no TF32 in cuBLAS or cuDNN (the
    program's own settings come back after)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class Reservoir:
    """A uniform sample of ``k`` items of a stream, drawn from ``seed``."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.items = k, random.Random(seed), []

    def offer(self, index: int, item) -> None:
        if index < self.k:
            self.items.append((index, item))
            return
        j = self.rng.randrange(index + 1)
        if j < self.k:
            self.items[j] = (index, item)
