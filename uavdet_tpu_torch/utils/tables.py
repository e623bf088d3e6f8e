"""Tables built once per shape and cached on a device (``cached_tables``),
and kept alive by the CUDA graphs that read them (``kept_tables``).

A CUDA graph reads its tensors by address. A table that a captured call
took from a bounded cache goes back to the caching allocator once the cache
drops it (evicted, or ``cache_clear()``), and every later replay would read
whatever was written there next, with no error. So a capture runs inside
``kept_tables()``, which gathers every table that a ``cached_tables``
function hands out on its thread, and the graphs hold that list.
"""

import contextlib
import functools
import threading

_local = threading.local()   # .kept: the open kept_tables's list, or None


def cached_tables(maxsize: int | None):
    """``functools.lru_cache(maxsize)`` whose results an open
    ``kept_tables()`` of the calling thread also keeps."""
    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def get(*args, **kwargs):
            out = cached(*args, **kwargs)
            kept = getattr(_local, "kept", None)
            if kept is not None:
                kept.append(out)
            return out

        get.cache_clear, get.cache_info = cached.cache_clear, cached.cache_info
        return get
    return wrap


@contextlib.contextmanager
def kept_tables():
    """Yields the list of every table the ``cached_tables`` functions hand
    out on this thread inside. Calls do not nest."""
    kept = _local.kept = []
    try:
        yield kept
    finally:
        _local.kept = None
