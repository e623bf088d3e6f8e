"""Debug guards: the port's copy of ``uavdet_tpu/utils/debug.py``, the
counterpart of the reference's NaN asserts (``assert not
torch.isnan(x).any()`` in its collate, loss path and DySOEM forward).

* ``enable_nan_debugging()``: ``torch.autograd.set_detect_anomaly``, which
  names the forward operation whose backward made a NaN (the JAX package
  flips ``jax_debug_nans``);
* ``checked(fn)``: ``fn`` with its floating outputs checked for NaN and
  infinity after each call;
* ``assert_finite(tree, name)``: a check of a nested structure of tensors
  or arrays, for use between steps.
"""

import functools

import numpy as np
import torch


def enable_nan_debugging(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)


def _leaves(tree, path: str):
    """(path, leaf) of nested dicts, lists, tuples and NamedTuples."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _leaves(v, f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _finite(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return not leaf.is_floating_point() or bool(
            torch.isfinite(leaf).all())
    arr = np.asarray(leaf)
    return arr.dtype.kind != "f" or bool(np.isfinite(arr).all())


def assert_finite(tree, name: str = "tree") -> None:
    """Raises ``FloatingPointError`` naming the first leaf of ``tree`` (nested
    dicts, lists, tuples and NamedTuples of tensors or arrays) that holds a
    NaN or an infinity. Reading a leaf on the card waits for it."""
    for path, leaf in _leaves(tree, name):
        if not _finite(leaf):
            raise FloatingPointError(f"non-finite values in {path}")


def checked(fn):
    """``fn`` whose floating outputs are checked after each call: a NaN or
    an infinity raises ``FloatingPointError`` naming the output. The JAX
    package checks inside the compiled program with ``checkify``; torch has
    no such in-graph check, so this one reads the outputs after ``fn``
    returns (and waits for the card to finish them)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        assert_finite(out, f"output of {getattr(fn, '__name__', 'fn')}")
        return out

    return wrapper
