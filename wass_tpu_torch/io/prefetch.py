"""Threaded PNG prefetch: decode frames ahead of the stereo loop.

The port's counterpart of the JAX package's native Prefetcher
(wass_tpu/native/__init__.py:170-203, a C++ thread pool on libpng), with
its interface: submit(path) -> ticket, take(ticket) -> (H, W) uint8,
close().  The native library does not build where the port runs (no
libpng headers), so a pool of Python threads decodes through io/png.py,
whose OpenCV decode releases the interpreter lock: the threads decode at
once, whatever row filters the PNGs use.  A decode error is raised by
take(), in the caller's thread.  Each decode is the span "prefetch.decode"
of the frame given to submit(), in the recorder of the submitting
thread's scope (instrument.py).  Several threads may submit and take at
once (the stereo loop's slot threads share one Prefetcher).
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict

import numpy as np

from wass_tpu_torch import instrument
from wass_tpu_torch.io.png import read_gray


class Prefetcher:
    def __init__(self, n_threads: int = 4):
        self._pool = ThreadPoolExecutor(max_workers=n_threads, thread_name_prefix="png-prefetch")
        self._pending: Dict[int, Future] = {}
        self._next = 0
        self._lock = threading.Lock()

    @staticmethod
    def _decode(path, frame: int, recorder) -> np.ndarray:
        with instrument.frame_scope({}, frame, recorder), instrument.span("prefetch.decode"):
            try:
                return read_gray(path)
            except ValueError as e:
                raise ValueError(f"{path}: {e}") from e

    def submit(self, path, frame: int = 0) -> int:
        """A ticket for the decode of `path`, timed for frame `frame`."""
        scope = instrument.current()
        with self._lock:
            ticket = self._next
            self._next += 1
            self._pending[ticket] = self._pool.submit(self._decode, path, frame, scope and scope.recorder)
        return ticket

    def take(self, ticket: int) -> np.ndarray:
        """The decoded image of a ticket (waits for it); raises what its
        decode raised."""
        return self._pending.pop(ticket).result()

    def close(self) -> None:
        """Drop the images not taken and stop the threads."""
        self._pool.shutdown(wait=True, cancel_futures=True)
        self._pending.clear()

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
