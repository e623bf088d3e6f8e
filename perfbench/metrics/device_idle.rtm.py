"""Percent of a call's time in the unprofiled window in which no kernel,
copy or set ran on the device: 1 - the device's busy time a call (the
union of its intervals over a short profiled slice of steady calls) / the
window's wall time a call."""

from perfbench.readers import device_idle as read  # noqa: F401
