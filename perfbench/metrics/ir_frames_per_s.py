"""Frames of every call issued in the window / the window (host clock,
from a synchronize to one after the last call)."""

from perfbench.readers import rate as read  # noqa: F401
