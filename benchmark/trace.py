"""The traced run: torch.profiler over the window, reduced to the device's
busy time, its idle gaps and the device operations that took most time.

The window is the profiler range WINDOW, opened by cell.py around the
stereo() call.  Device operations are the trace's CUDA events (kernels,
copies, memsets); busy time is the union of their intervals inside the
window.  Each idle gap is labelled with the innermost host operation that
the dispatching thread was running at the gap's middle (another thread's
where it ran none).
"""

from __future__ import annotations

import contextlib

WINDOW = "benchmark.window"
TOP = 10


@contextlib.contextmanager
def profiled(enabled: bool):
    """A profiler over the block (or None when not enabled)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof


def _events(prof):
    from torch.autograd import DeviceType

    window, host, device = None, [], []
    for e in prof.profiler.kineto_results.events():
        dt = e.device_type()
        if dt == DeviceType.CPU:
            if e.name() == WINDOW:
                window = (e.start_ns(), e.end_ns(), e.start_thread_id())
            else:
                host.append((e.start_ns(), e.end_ns(), e.name(), e.start_thread_id()))
        elif dt == DeviceType.CUDA and not e.is_user_annotation() and e.name() != WINDOW:
            device.append((e.start_ns(), e.end_ns(), short_name(e.name())))
    return window, host, device


def short_name(name: str) -> str:
    """A device operation's name without its return type, anonymous
    namespace and parameter list: "sgm_path_kernel<4, 1>"."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i else name
                break
    return name[:160]


def _union(intervals, lo, hi):
    merged = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e, *_ in intervals if e > lo and s < hi):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _label(host, main_tid, t):
    best = None
    for s, e, name, tid in host:
        if s <= t < e:
            key = (tid == main_tid, s)
            if best is None or key > best[0]:
                best = (key, name)
    return best[1] if best else "no traced host operation"


def summarize(prof) -> dict:
    """The reduction of a profiler's trace (see reduce)."""
    window, host, device = _events(prof)
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW} range")
    return reduce(window, host, device)


def reduce(window, host, device) -> dict:
    """busy_s, window_s, device time by operation name, and the TOP device
    operations and longest idle gaps with their labels, from the window
    (start_ns, end_ns, thread), host events (start_ns, end_ns, name, thread)
    and device events (start_ns, end_ns, name)."""
    lo, hi, main_tid = window
    busy = _union(device, lo, hi)
    busy_ns = sum(e - s for s, e in busy)
    by_name: dict = {}
    inside = [(s, e, n) for s, e, n in device if e > lo and s < hi]
    for s, e, n in inside:
        by_name[n] = by_name.get(n, 0.0) + (min(e, hi) - max(s, lo)) * 1e-9
    gaps, prev = [], lo
    for s, e in busy + [[hi, hi]]:
        if s > prev:
            gaps.append((s - prev, prev, s))
        prev = max(prev, e)
    gaps.sort(reverse=True)
    host_in = [h for h in host if h[1] > lo and h[0] < hi]
    idle = [[_label(host_in, main_tid, (a + b) // 2), d * 1e-9] for d, a, b in gaps[:TOP]]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"window_s": (hi - lo) * 1e-9, "busy_s": busy_ns * 1e-9, "by_name": by_name,
            "device_ops": [[n, s] for n, s in top], "idle_gaps": idle, "n_device_events": len(inside)}
