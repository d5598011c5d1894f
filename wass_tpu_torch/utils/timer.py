"""Named-event stage timer (cvlab::HiresTimer equivalent).

The port's own copy of wass_tpu/utils/timer.py: the reference instruments
every stage with `timer << "Dense Stereo"` events and renders a per-task
seconds table at exit (hires_timer.h:28-60, render.hpp:175-191 of the
WASS sources).  Same table text here.
"""

from __future__ import annotations

import time
from typing import List, Tuple


class StageTimer:
    def __init__(self):
        self.start_time = time.perf_counter()
        self._last = self.start_time
        self.events: List[Tuple[str, float]] = []

    def mark(self, name: str) -> float:
        """Record the time elapsed since the previous mark under `name`."""
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        self.events.append((name, dt))
        return dt

    # The reference's `timer << "name"` idiom.
    def __lshift__(self, name: str) -> "StageTimer":
        self.mark(name)
        return self

    @property
    def total(self) -> float:
        return time.perf_counter() - self.start_time

    def table(self) -> str:
        """Per-task seconds table (render.hpp:175-191 format)."""
        width = max([len(n) for n, _ in self.events] + [10])
        rule = "+" + "-" * (width + 2) + "+" + "-" * 12 + "+"
        lines = [rule, f"| {'Task':<{width}} | {'Secs':>10} |", rule]
        lines += [f"| {name:<{width}} | {dt:>10.3f} |" for name, dt in self.events]
        lines += [rule, f"| {'Total':<{width}} | {self.total:>10.3f} |", rule]
        return "\n".join(lines)
