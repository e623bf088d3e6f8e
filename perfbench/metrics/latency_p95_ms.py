"""The 95th percentile over every call in the window of the host time from
issuing the call to its answer on the host (one call in flight)."""

from perfbench.readers import latency_p95_ms as read  # noqa: F401
