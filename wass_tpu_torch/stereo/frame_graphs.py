"""CUDA graphs of a dense frame's device work, replayed by the stereo loop.

On a card the dispatching thread does not enqueue a frame's ~1270 launches
one by one: it replays them from CUDA graphs captured once from the same
eager functions.  R is the rectification (dense.rectify_pair: the two
float casts and the warps); D is the dense frame up to the plane's host
read (DenseStereoPipeline.device_part: census, the c2f coarse pass and row
windows, the windowed SGM, the postprocess, triangulation, z-gap
components, RANSAC, the first crop and the plane's covariance).  After D
the loop reads the covariance on the host and solves the 3x3
eigenproblem there (dense.plane_normal_read, into a pinned buffer of the
instance: a read into pageable memory holds the CUDA driver until D
ends, and every writer's CUDA call waits with it), copies the normal into
a static device buffer and replays F, the plane's tail
(DenseStereoPipeline.tail: the plane, its final crop, the point count)
and the frame's .xyzC export (dense.export_frame: the payload rows as u16
bits and a small float64 header, which the writers only copy to the
host), whose ~50 small launches cost ~0.25 ms each on a host whose other
threads are busy.  F runs on the dispatching stream behind D, so the
export never shares the card with another frame's D.  Every hand-written
kernel is launched from the graphs; the outputs are the eager path's, bit
for bit.  CPU runs stay eager.

A slot's frames take turns on a ring of instances (FrameRing): frame i of
a slot uses instance `instance_index(i, n_slots, depth)`, one of
dispatch_depth + 1.  The loop keeps at most dispatch_depth frames of a
slot in flight, so by the time an instance is used again the writer of
its previous frame has returned; that writer also records the instance's
`done` event on its stream after its last read, and the dispatching
stream waits on it before the instance's next upload.  Each instance owns
pinned staging buffers (the decoded pair, the plane's covariance and
normal), its static device inputs (the uint8 base and match images, the
plane's normal), graphs R, D and F and their static outputs,
which each replay overwrites.  The graphs of a ring share one memory pool,
the size of one frame's intermediates: each graph copies its outputs out
of the pool into its instance's static tensors, so nothing in the pool
outlives a replay, and replays, one at a time on the dispatching stream,
may come in any order.  A writer's full-range re-run of a frame whose c2f
guard tripped stays eager and reads the instance's rectified pair.

Rings are cached in this module, as grid/variational.py keeps its graphs:
a sequence captures once, and later stereo() calls with the same key
replay.  The key is what the captured work depends on: the slot, the
device, the image shape and type, the dense configuration (AUTO smoothing
resolved), the H2 switch (sgm_kernels._USE_H2, read at call time) and the
rig (the geometry cache key; the graphs read the geometry pack's tensors,
which the ring keeps).  The newest KEYS_PER_SLOT keys of a slot are kept,
so a sequence whose rig changes every frame pays a capture a frame
(counted) and holds no more memory.

Capture runs the eager functions under thread_local capture mode on a
stream of the slot's own, while the writers and the prefetch threads go
on; captures hold a lock, so two slots take turns.  A ring's first
capture of each graph follows one eager run of it on that stream, which
makes what a capture may not (the kernel library's modules loaded, the
library handles for the stream, the census blur taps and the RANSAC draws
on the device) and gives the shapes of the static outputs; before a
ring's first capture the allocator's cache is emptied, since an
allocation that fails inside a capture cannot free the pools of evicted
rings.  The launches a
capture records are counted at each replay (instrument.replay_launches),
so a frame's launch line is the eager path's; the counters
dense_graph_captures (instances captured in the frame) and
dense_graph_replays (1 a replayed frame) say that the graphs engage.
After a frame whose instance was captured, the ring reads the bytes its
pool holds (FrameRing.pool_bytes; the loop counts them each frame as
dense_graph_pool_bytes).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Tuple

import numpy as np
import torch

from wass_tpu_torch import instrument
from wass_tpu_torch.instrument import count, frame_scope
from wass_tpu_torch.stereo import sgm_kernels
from wass_tpu_torch.stereo.dense import (
    DenseFrameResult,
    DenseStereoPipeline,
    FrameExport,
    FrameParts,
    plane_normal_read,
    rectify_pair,
)

# The ring keys a slot keeps.
KEYS_PER_SLOT = 2

_lock = threading.Lock()
# Held by a capture: two slots never capture at once.
_capture_lock = threading.Lock()
# (slot, device) -> OrderedDict(ring key -> FrameRing), the newest last.
_RINGS: dict = {}
# (slot, device) -> the stream the slot captures on.
_STREAMS: dict = {}


def engages(device) -> bool:
    """Whether the loop replays the frames of `device` from graphs: on a
    card."""
    return torch.device(device).type == "cuda"


def instance_index(i: int, n_slots: int, depth: int) -> int:
    """The ring instance of frame i, whose slot takes every n_slots-th
    frame and keeps at most `depth` of them in flight."""
    return (i // n_slots) % (depth + 1)


def ring_key(slot: int, device, shape, dtype, cfg, geom_key) -> tuple:
    """What a ring's graphs depend on (see the module docstring)."""
    return (slot, str(torch.device(device)), tuple(shape), np.dtype(dtype).str, cfg, bool(sgm_kernels._USE_H2),
            geom_key)


def ring_for(slot: int, device, shape, dtype, cfg, geom_key, geom_pack: dict) -> "FrameRing":
    """The cached ring of the key, made (with geom_pack, whose tensors its
    graphs will read) when it is new; a slot's oldest key goes beyond
    KEYS_PER_SLOT."""
    key = ring_key(slot, device, shape, dtype, cfg, geom_key)
    with _lock:
        rings = _RINGS.setdefault(key[:2], OrderedDict())
        ring = rings.get(key)
        if ring is None:
            ring = rings[key] = FrameRing(key, device, shape, dtype, geom_pack)
            while len(rings) > KEYS_PER_SLOT:
                rings.popitem(last=False)
        else:
            rings.move_to_end(key)
        return ring


def _capture_stream(slot: int, device: torch.device) -> torch.cuda.Stream:
    key = (slot, str(device))
    with _lock:
        stream = _STREAMS.get(key)
        if stream is None:
            # From the high-priority pool: the writers take theirs from the
            # default-priority one, so none of them can enqueue work on a
            # stream while a capture holds it.
            stream = _STREAMS[key] = torch.cuda.Stream(device, priority=-1)
        return stream


def _on_side_stream(stream: torch.cuda.Stream, fn: Callable):
    """fn() on `stream`, ordered after the current stream's work and before
    its next."""
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        out = fn()
    current.wait_stream(stream)
    return out


def _map(fn, tree, *others):
    """fn over the tensors of a tree of tuples, named tuples and dicts (and
    over the matching leaves of `others`, trees of the same shape); other
    leaves are kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *others)
    if isinstance(tree, tuple):
        items = [_map(fn, t, *(o[k] for o in others)) for k, t in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(o[k] for o in others)) for k, v in tree.items()}
    return tree


def _warm_up(stream: torch.cuda.Stream, fn: Callable):
    """One eager run of fn on the capture stream; returns its outputs.  Its
    launches count in the totals, not for the frame; its spans are not
    recorded."""
    scope = instrument.current()
    with frame_scope({}, scope.index if scope is not None else 0):
        return _on_side_stream(stream, fn)


def _capture(stream: torch.cuda.Stream, fn: Callable, static, inputs: set, pool):
    """(graph, its outputs, the launches it recorded) of fn captured on
    `stream` in `pool` (a new one when None): each output tensor is copied
    into its place in `static`, a tree shaped as fn's outputs, unless it is
    one of the tensors whose ids `inputs` holds, which stays itself.  So
    no output lives in the pool, and the graphs that share it may replay
    in any order, one at a time."""
    graph = torch.cuda.CUDAGraph()

    def keep(s, t):
        return t if id(t) in inputs else s.copy_(t)

    def captured():
        with instrument.captured_launches() as launches:
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                out = _map(keep, static, fn())
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:  # the failed call may have invalidated the capture
                    pass
                raise
            graph.capture_end()
        return out, launches

    out, launches = _on_side_stream(stream, captured)
    return graph, out, launches


def pool_bytes(pool, device) -> int:
    """The bytes the caching allocator's segments of memory pool `pool` (a
    CUDAGraph.pool() handle) hold on CUDA device `device`."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if seg["device"] == index and tuple(seg["segment_pool_id"]) == tuple(pool))


class FrameInstance:
    """One instance of a ring: staging buffers, static inputs, graphs R, D
    and F and their static outputs (see the module docstring)."""

    def __init__(self, ring: "FrameRing"):
        H, W = ring.shape
        dtype = torch.from_numpy(np.empty(0, ring.dtype)).dtype
        self.staging = [torch.empty((H, W), dtype=dtype, pin_memory=True) for _ in range(2)]
        self.inputs = tuple(torch.empty((H, W), dtype=dtype, device=ring.device) for _ in range(2))
        self.cov_staging = torch.empty((3, 3), dtype=torch.float32, pin_memory=True)
        self.normal_staging = torch.empty(3, dtype=torch.float32, pin_memory=True)
        self.normal = torch.zeros(3, dtype=torch.float32, device=ring.device)
        # The inputs' copies out of the staging buffers; the writer of the
        # instance's last frame done with its outputs.
        self.copied = torch.cuda.Event()
        self.done = torch.cuda.Event()
        # kind -> (graph, its static outputs, the launches it recorded).
        self.graphs: dict = {}
        self.rect = self.parts = None

    def _replayed(self, ring: "FrameRing", kind: str, fn: Callable, inputs):
        """The static outputs of graph `kind` (fn's), replayed on the current
        stream; captured first if new, after the ring's eager run of fn
        when the ring has not run this kind yet."""
        entry = self.graphs.get(kind)
        if entry is None:
            stream = ring.capture_stream()
            with _capture_lock:
                if ring.pool is None:
                    # What evicted rings and eager runs left cached: a
                    # capture cannot free memory itself.
                    torch.cuda.empty_cache()
                if kind not in ring.templates:
                    ring.templates[kind] = _map(lambda t: torch.empty_like(t, device="meta"), _warm_up(stream, fn))
                static = _map(lambda t: torch.empty_like(t, device=ring.device), ring.templates[kind])
                ids = {id(t) for t in _leaves(inputs)}
                entry = self.graphs[kind] = _capture(stream, fn, static, ids, ring.pool)
                ring.pool = entry[0].pool()
        graph, out, launches = entry
        graph.replay()
        instrument.replay_launches(launches)
        return out

    def upload(self, base_img: np.ndarray, match_img: np.ndarray):
        """The frame's decoded pair into the static inputs: host copies into
        the staging buffers, then two asynchronous copies on the current
        stream, after the instance's last frame is done with them."""
        self.copied.synchronize()
        for buf, img in zip(self.staging, (base_img, match_img)):
            np.copyto(buf.numpy(), img)
        stream = torch.cuda.current_stream(self.inputs[0].device)
        stream.wait_event(self.done)
        for dst, src in zip(self.inputs, self.staging):
            dst.copy_(src, non_blocking=True)
        self.copied.record(stream)
        return self.inputs

    def rectify(self, ring: "FrameRing"):
        """Graph R replayed: the rectified pair."""
        self.rect = self._replayed(ring, "rectify", lambda: rectify_pair(*self.inputs, ring.geom_pack, ring.shape),
                                   self.inputs)
        return self.rect

    def dense(self, ring: "FrameRing", pipe: DenseStereoPipeline) -> FrameParts:
        """Graph D replayed (after rectify): the frame's device part."""
        self.parts = self._replayed(ring, "dense", lambda: pipe.device_part(*self.rect, ring.geom_pack), self.rect)
        return self.parts

    def finish(self, ring: "FrameRing", pipe: DenseStereoPipeline,
               export: Callable) -> Tuple[DenseFrameResult, FrameExport]:
        """The plane's normal from the host read (after dense), copied to the
        device, then graph F replayed: the frame's result and its export,
        export(result, the frame's c2f diagnostics), whose capture F holds
        (the loop passes the same function every frame)."""
        new = "tail" not in self.graphs
        # The staging buffer's last copy is done: the writer of the
        # instance's last frame, which has returned, read F's outputs.
        self.normal_staging.copy_(plane_normal_read(self.parts.plane, self.cov_staging))
        self.normal.copy_(self.normal_staging, non_blocking=True)

        def tail():
            res = pipe.tail(self.parts, self.normal)
            return res, export(res, self.parts.c2f)

        result = self._replayed(ring, "tail", tail, (self.parts, self.normal))
        if new:
            ring.pool_bytes = pool_bytes(ring.pool, ring.device)
            count("dense_graph_captures")
        count("dense_graph_replays")
        return result


def _leaves(tree) -> list:
    out: list = []
    _map(out.append, tree)
    return out


class FrameRing:
    """A slot's ring of FrameInstances for one key, made as frames need
    them.  Only its slot's dispatching thread uses it."""

    def __init__(self, key: tuple, device, shape, dtype, geom_pack: dict):
        self.key = key
        self.slot = key[0]
        self.device = torch.device(device)
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.geom_pack = geom_pack
        self.instances: dict = {}
        # The memory pool its instances' graphs share, the bytes it held
        # after the latest capture, and the outputs of its eager runs (as
        # meta tensors), the shapes of their static ones.
        self.pool = None
        self.pool_bytes = 0
        self.templates: dict = {}

    def instance(self, k: int) -> FrameInstance:
        inst = self.instances.get(k)
        if inst is None:
            inst = self.instances[k] = FrameInstance(self)
        return inst

    def capture_stream(self) -> torch.cuda.Stream:
        return _capture_stream(self.slot, self.device)
