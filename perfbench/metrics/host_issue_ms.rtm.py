"""Host milliseconds of one call into the entry, the device drained before
each call: the median over the traced run's slice of calls."""

from perfbench.readers import issue_ms as read  # noqa: F401
