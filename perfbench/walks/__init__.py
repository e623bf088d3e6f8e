"""FLOP and byte counts of whole models, one module per walk: a
configuration names its walk (``"walk"``), and ``rows(batch, size,
hparams)`` prices every conv of the model at those shapes."""

import importlib


def rows(config: dict, batch: int, size: int) -> list:
    mod = importlib.import_module(f"perfbench.walks.{config['walk']}")
    return mod.rows(batch, size, config["hparams"])


def flops(config: dict, batch: int, size: int) -> float:
    """The forward's FLOPs at (batch, size)."""
    return sum(r.flops for r in rows(config, batch, size))
