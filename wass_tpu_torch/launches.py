"""Kernel launch counts, safe under threads and attributable to a frame.

Each kernel wrapper adds one to its key of a LaunchCounts (one dict per
kernel module) where it launches its kernel.  The sequence loop launches
from more than one thread: the main thread dispatches frames while a
writer thread may re-run a frame at full range (the deferred c2f
fallback).  So an increment takes a lock, and a thread that opens
`frame_scope(counts)` also collects its own launches into `counts`: the
frame's dispatch and its re-run add to the same dict, and no other
frame's launches do.
"""

from __future__ import annotations

import contextlib
import threading

_lock = threading.Lock()
_local = threading.local()


class LaunchCounts(dict):
    """Launches by kernel name since the last reset."""

    def add(self, key: str) -> None:
        with _lock:
            self[key] += 1
            scope = getattr(_local, "scope", None)
            if scope is not None:
                scope[key] = scope.get(key, 0) + 1

    def reset(self) -> None:
        with _lock:
            for k in self:
                self[k] = 0


@contextlib.contextmanager
def frame_scope(counts: dict):
    """Collect this thread's launches into `counts` (as well as the totals)
    for the duration of the block."""
    outer = getattr(_local, "scope", None)
    _local.scope = counts
    try:
        yield counts
    finally:
        _local.scope = outer
