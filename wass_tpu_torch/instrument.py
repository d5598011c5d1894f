"""What the stereo loop records, safe under threads and attributable to a
frame: kernel launch counts, spans and counters.

Each kernel wrapper adds one to its key of a LaunchCounts (one dict per
kernel module) where it launches its kernel.  The sequence loop launches
from more than one thread: the main thread dispatches frames while a
writer thread may re-run a frame at full range (the deferred c2f
fallback).  So an increment takes a lock, and a thread that opens
`frame_scope(launches, index, recorder)` also collects its own launches
into `launches`: the frame's dispatch and its re-run add to the same dict,
and no other frame's launches do.  Inside `captured_launches` (a CUDA
graph's capture) a thread's launches are recorded instead of counted, and
`replay_launches` counts them at each replay of the graph, as the eager
calls would have been counted.

A `span(name)` times a block of the thread that runs it, for the frame of
the thread's scope, on `time.time_ns()`'s clock (torch.profiler's):
duration, self time (the duration less the part its children cover; the
children come from a thread-local stack) and, where asked, the thread's
CPU time.  The Recorder of the scope sums them per frame and name, so it
keeps a few floats a frame whatever the sequence's length.  Only while a
torch.profiler records does a span also open a `record_function` range of
the same name, with the frame index as its args, and keep its record whole
(`Recorder.records`), for matching against the trace.  With no recorder in
the scope a span only reads the clock; with no profiler recording it costs
a flag test and two clock reads besides the sums.  `count(key)` adds to a
counter of the frame the same way, and `host_read` is the one place a
dispatching thread reads the device on purpose: the read's span, and one
count of `host_reads`.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

_lock = threading.Lock()
_local = threading.local()


class LaunchCounts(dict):
    """Launches by kernel name since the last reset."""

    def add(self, key: str) -> None:
        with _lock:
            captured = getattr(_local, "captured", None)
            if captured is not None:
                captured.append((self, key))
                return
            self[key] += 1
            scope = getattr(_local, "scope", None)
            if scope is not None:
                scope.launches[key] = scope.launches.get(key, 0) + 1

    def reset(self) -> None:
        with _lock:
            for k in self:
                self[k] = 0


@contextlib.contextmanager
def captured_launches():
    """Record this thread's kernel launches in the block, in the list it
    yields, instead of counting them: the block is a CUDA graph's capture,
    whose kernels run at each replay (replay_launches)."""
    outer = getattr(_local, "captured", None)
    _local.captured = recorded = []
    try:
        yield recorded
    finally:
        _local.captured = outer


def replay_launches(recorded: list) -> None:
    """Count the launches a capture recorded, in the totals and for the
    thread's frame, as each kernel call of the capture would have been."""
    for counts, key in recorded:
        counts.add(key)


class Recorder:
    """The spans and counters of one run, summed per frame index.

    `each` names spans whose every duration is also kept, in the order
    they end, under a key of its own (span name -> key)."""

    def __init__(self, each: Optional[Dict[str, str]] = None):
        self._sums: Dict[str, List[float]] = {}
        self._each = {key: [] for key in (each or {}).values()}
        self._each_key = dict(each or {})
        self._parents: set = set()
        # (name, frame, parent name, thread, start ns, end ns, CPU ns or
        # None) of every span that ended while a profiler recorded.
        self.records: list = []

    def _add(self, key: str, index: int, value: float) -> None:
        sums = self._sums.setdefault(key, [])
        if len(sums) <= index:
            sums.extend([0.0] * (index + 1 - len(sums)))
        sums[index] += value

    def add(self, key: str, index: int, value: float) -> None:
        """Add `value` to the counter `key` of frame `index`."""
        with _lock:
            self._add(key, index, value)

    def _end(self, sp: "span", t1: int, cpu_ns: Optional[int]) -> None:
        index, dur = sp._scope.index, t1 - sp._t0
        with _lock:
            self._add(sp.name, index, dur * 1e-9)
            if sp._child:
                self._parents.add(sp.name)
                self._add(sp.name + ".child", index, sp._child * 1e-9)
            if cpu_ns is not None:
                self._add(sp.name + ".cpu", index, cpu_ns * 1e-9)
            key = self._each_key.get(sp.name)
            if key is not None:
                self._each[key].append(dur * 1e-9)
            if sp._rf is not None:
                parent = sp._parent.name if sp._parent is not None else None
                self.records.append((sp.name, index, parent, threading.get_ident(), sp._t0, t1, cpu_ns))

    def stats(self) -> Dict[str, list]:
        """One list a key, one entry a frame (0 where the key did not fire
        in that frame; frames up to the highest index seen): each span's
        seconds under its name, its self seconds under `<name>.self` where
        it had children, its CPU seconds under `<name>.cpu` where asked,
        each counter under its key; and the `each` lists."""
        with _lock:
            n = max((len(v) for v in self._sums.values()), default=0)
            sums = {k: v + [0.0] * (n - len(v)) for k, v in self._sums.items()}
            out = {k: v for k, v in sums.items() if not k.endswith(".child")}
            for name in self._parents:
                out[name + ".self"] = [d - c for d, c in zip(sums[name], sums[name + ".child"])]
            out.update((k, list(v)) for k, v in self._each.items())
        return out


class _Scope:
    __slots__ = ("launches", "index", "recorder", "dispatching")

    def __init__(self, launches: dict, index: int, recorder: Optional[Recorder], dispatching: bool):
        self.launches, self.index, self.recorder, self.dispatching = launches, index, recorder, dispatching


@contextlib.contextmanager
def frame_scope(launches: dict, index: int = 0, recorder: Optional[Recorder] = None, dispatching: bool = False):
    """Collect this thread's launches into `launches` (as well as the
    totals), and its spans and counters into `recorder` under frame
    `index`, for the duration of the block.  `dispatching` marks the
    thread that dispatches the frame (or a thread working for it), whose
    device reads `host_read` counts."""
    outer = getattr(_local, "scope", None)
    _local.scope = _Scope(launches, index, recorder, dispatching)
    try:
        yield launches
    finally:
        _local.scope = outer


def current() -> Optional[_Scope]:
    """The thread's scope (None outside any), to hand to another thread."""
    return getattr(_local, "scope", None)


class span:
    """Times the block as `name` (see the module docstring); `cpu` also
    reads the thread's CPU time.  `elapsed()` gives the seconds so far."""

    __slots__ = ("name", "cpu", "_scope", "_parent", "_child", "_rf", "_t0", "_c0")

    def __init__(self, name: str, cpu: bool = False):
        self.name = name
        self.cpu = cpu

    def __enter__(self) -> "span":
        scope = getattr(_local, "scope", None)
        self._scope = scope if scope is not None and scope.recorder is not None else None
        self._rf = None
        if self._scope is not None:
            stack = _local.__dict__.setdefault("stack", [])
            self._parent = stack[-1] if stack else None
            self._child = 0
            stack.append(self)
            if _profiler._is_profiler_enabled:
                self._rf = torch.profiler.record_function(self.name, str(scope.index))
                self._rf.__enter__()
            if self.cpu:
                self._c0 = time.thread_time_ns()
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.time_ns()
        if self._scope is None:
            return False
        cpu_ns = time.thread_time_ns() - self._c0 if self.cpu else None
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        _local.stack.pop()
        if self._parent is not None:
            self._parent._child += t1 - self._t0
        self._scope.recorder._end(self, t1, cpu_ns)
        return False

    def elapsed(self) -> float:
        return (time.time_ns() - self._t0) * 1e-9


def count(key: str, n: float = 1.0) -> None:
    """Add n to the counter `key` of the thread's frame (nothing outside a
    recorder's scope)."""
    scope = getattr(_local, "scope", None)
    if scope is not None and scope.recorder is not None:
        scope.recorder.add(key, scope.index, n)


def host_read(t: torch.Tensor, name: str) -> torch.Tensor:
    """`t` on the host: a read that waits for the device work behind it,
    timed as the span `name` and, on a dispatching thread, counted under
    `host_reads`."""
    with span(name):
        out = t.cpu()
    scope = getattr(_local, "scope", None)
    if scope is not None and scope.dispatching:
        count("host_reads")
    return out
