"""The stereo loop's spans and counters (wass_tpu_torch/instrument.py) on
the CPU: the recorder's sums, self times and memory; stereo()'s
loop_stats through one slot and through three (3 slots on the CPU, each
dispatching from a thread of its own), where every span key holds one
entry a frame and children fit in their parents; the dispatching thread's top-level spans
covering the call; one counted host read a frame; the writers' render
phases (build, fetch, encode, write) and counters (render_bytes,
render_device_images, render_images) inside writer.render, none with the
renders off, and the
benchmark's readers of them; and the profiler ranges: one
record_function range a span, on the span's clock, while a profiler
records, and none otherwise; the writers' two counted host reads a frame
(the export's header and payload), whose .xyzC files are the old
writer-side export's, byte for byte."""

import dataclasses
import io
import shutil
import threading
import time
import types
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import spec as bench_spec
from wass_tpu_torch import instrument
from wass_tpu_torch.cli import pipeline as pipeline_mod
from wass_tpu_torch.cli.main import load_pipeline
from wass_tpu_torch.cli.pipeline import LEGACY_KEYS, SequenceConfig, SequencePipeline
from wass_tpu_torch.core.geometry import rt_from_plane
from wass_tpu_torch.instrument import Recorder, count, frame_scope, host_read, span
from wass_tpu_torch.io.xyzc import save_xyz_quantized
from wass_tpu_torch.parallel import mesh as tmesh
from wass_tpu_torch.stereo.dense import DenseStereoConfig, export_u16, fetch_u16
from wass_tpu_torch.testing import write_pairs, write_sequence
from wass_tpu_torch.testing.synthetic import make_rig, make_scene
from torch_registries import reset_registries  # noqa: F401  (autouse)

N_FRAMES = 4
TOP = ("loop.start", "loop.take", "loop.dispatch", "loop.writer_wait", "loop.drain")
# (parent, children) on one thread of the pipelined loop.
NESTING = [
    ("loop.dispatch", ("loop.rig", "loop.upload", "loop.rectify", "dense.frame", "loop.submit")),
    ("dense.frame", ("dense.census", "dense.disparity", "dense.post", "dense.plane")),
    ("dense.plane", ("plane.read",)),
    ("writer.finalize", ("writer.device_wait", "writer.fetch", "writer.write", "writer.render")),
    ("writer.render", ("writer.render.build", "writer.render.fetch", "writer.render.encode", "writer.render.write")),
]
RENDER_SPANS = NESTING[-1][1]
# The benchmark's readers of the render spans and counters, and the key each
# reads.
RENDER_READERS = {"writers.render_build_ms": "writer.render.build", "writers.render_fetch_ms": "writer.render.fetch",
                  "writers.render_encode_ms": "writer.render.encode", "writers.render_mb": "render_bytes"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Spy:
    """record_function as the spans call it, keeping each (name, args)."""

    def __init__(self, seen, real):
        self.seen, self.real = seen, real

    def __call__(self, name, args=None):
        self.seen.append((name, args))
        return self.real(name, args)


def _raise(*a, **k):
    raise AssertionError("record_function entered with no profiler recording")


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    """4 frame workdirs of one 256x192 scene (c2f with 32-disparity windows)."""
    root = tmp_path_factory.mktemp("tracing")
    rig = make_rig(width=256, height=192)
    sc = make_scene(seed=61, width=256, height=192, wave_amplitude=0.25, rig=rig, time=0.1)
    write_sequence(root / "base", sc.img0, sc.img1, rig, N_FRAMES)
    (root / "base" / "stereo_config.txt").write_text("MAX_DISPARITY=96\n")
    return root


def _pipelined(seq, name):
    path = seq / name
    shutil.copytree(seq / "base", path)
    pipe = load_pipeline(path, "cpu")
    pipe.cfg = dataclasses.replace(pipe.cfg, stereo=dataclasses.replace(pipe.cfg.stereo, c2f_window=32))
    return pipe


@pytest.fixture(scope="module")
def plain(seq):
    """The pipelined loop with no profiler, record_function made to raise:
    (pipe, the stereo() call's seconds)."""
    pipe = _pipelined(seq, "plain")
    mp = pytest.MonkeyPatch()
    mp.setattr(torch.profiler, "record_function", _raise)
    try:
        t0 = time.perf_counter()
        pipe.stereo(progress_stream=io.StringIO())
        wall = time.perf_counter() - t0
    finally:
        mp.undo()
    return pipe, wall


@pytest.fixture(scope="module")
def profiled(seq):
    """The pipelined loop under a CPU profiler of every thread: (the
    recorder, the (name, args) each span gave record_function, the
    profiler's events)."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    pipe = _pipelined(seq, "profiled")
    made, seen = [], []

    class Keep(Recorder):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    mp = pytest.MonkeyPatch()
    mp.setattr(pipeline_mod, "Recorder", Keep)
    mp.setattr(torch.profiler, "record_function", _Spy(seen, torch.profiler.record_function))
    try:
        with profile(activities=[ProfilerActivity.CPU],
                     experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
            pipe.stereo(progress_stream=io.StringIO())
    finally:
        mp.undo()
    events = [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()]
    return made[0], seen, events


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """5 frames of 96x64 over 3 CPU slots (frames 0 and 3, 1 and 4, and 2)."""
    root = tmp_path_factory.mktemp("tracing_sharded")
    rig = make_rig(width=96, height=64)
    scenes = [make_scene(seed=300 + i, width=96, height=64, wave_amplitude=0.25, rig=rig, time=i * 0.25)
              for i in range(5)]
    write_pairs(root, [(s.img0, s.img1) for s in scenes], rig)
    stereo = DenseStereoConfig(num_disp=16, min_disp=1, plane_ransac_rounds=64, plane_ransac_threshold=0.1,
                               plane_max_distance=0.3)
    pipe = SequencePipeline(root, SequenceConfig(stereo=stereo, device="cpu"))
    pipe._frame_mesh = lambda: tmesh.make_frame_mesh(devices=["cpu"] * 3)
    pipe.stereo(progress_stream=io.StringIO())
    return pipe


@pytest.fixture(scope="module")
def norender(seq):
    """The pipelined loop with the renders off (debug_renders = False)."""
    pipe = _pipelined(seq, "norender")
    pipe.cfg.debug_renders = False
    pipe.stereo(progress_stream=io.StringIO())
    return pipe


def _span_keys(stats):
    return [k for k in stats if k not in LEGACY_KEYS.values()]


@pytest.mark.parametrize("loop", ["pipelined", "sharded"])
def test_every_key_has_one_entry_a_frame(plain, sharded, loop):
    stats, n = (plain[0].loop_stats, N_FRAMES) if loop == "pipelined" else (sharded.loop_stats, 5)
    keys = _span_keys(stats)
    assert {*TOP, "loop.rig", "loop.upload", "dense.frame", "dense.plane", "plane.read", "loop.submit", "host_reads",
            "writer.finalize", "writer.device_wait", "writer.fetch", "writer.write", "prefetch.decode",
            "loop.dispatch.cpu", "loop.dispatch.self"} <= set(keys)
    for k in keys:
        assert len(stats[k]) == n and all(isinstance(v, float) for v in stats[k]), k
    assert len(stats["dispatch_s"]) == n


def test_children_fit_in_their_parents(plain):
    stats = plain[0].loop_stats
    for parent, children in NESTING:
        for i in range(N_FRAMES):
            assert sum(stats[c][i] for c in children) <= stats[parent][i], (parent, i)
    selfs = [k for k in stats if k.endswith(".self")]
    assert {"loop.dispatch.self", "dense.frame.self", "writer.finalize.self"} <= set(selfs)
    assert all(v >= 0 for k in selfs for v in stats[k])
    assert sum(stats["loop.dispatch.cpu"]) <= sum(stats["loop.dispatch"])


def test_dispatch_s_is_the_dispatch_span(plain):
    stats = plain[0].loop_stats
    assert stats["dispatch_s"] == stats["loop.dispatch"]
    assert len(stats["decode_s"]) == 2 * N_FRAMES
    assert sum(stats["decode_s"]) == pytest.approx(sum(stats["prefetch.decode"]))
    assert stats["render_s"] == stats["writer.render"]


def test_top_level_spans_cover_the_call(plain):
    pipe, wall = plain
    top = sum(sum(pipe.loop_stats[k]) for k in TOP)
    assert 0.99 * wall <= top <= wall


def test_one_counted_host_read_a_frame(plain, sharded):
    assert plain[0].loop_stats["host_reads"] == [1.0] * N_FRAMES
    assert sharded.loop_stats["host_reads"] == [1.0] * 5


def test_the_log_line_is_the_finalize_span(plain):
    pipe, _ = plain
    for i, wd in enumerate(sorted(Path(pipe.outdir).glob("*_wd"))):
        line = [ln for ln in (wd / "wass_stereo_log.txt").read_text().splitlines() if "finalize wall time" in ln][0]
        logged = float(line.split("finalize wall time: ")[1].rstrip("s"))
        before = pipe.loop_stats["writer.device_wait"][i] + pipe.loop_stats["writer.fetch"][i]
        assert before - 5e-4 <= logged <= pipe.loop_stats["writer.finalize"][i] + 5e-4


def test_every_span_is_a_profiler_range(profiled):
    """Each span's record_function range under the span's name with its
    frame as the args, and its start on the range's clock (within 1 ms of
    the range's bounds)."""
    rec, seen, events = profiled
    records = rec.records
    assert len(records) > 20 * N_FRAMES
    assert Counter(seen) == Counter((r[0], str(r[1])) for r in records)
    assert {r[0] for r in records} >= {*TOP, "writer.finalize", "prefetch.decode", "plane.read"}
    assert {r[1] for r in records} == set(range(N_FRAMES))
    ranges: dict = {}
    for name, s, e in events:
        ranges.setdefault(name, []).append((s, e))
    for name in {r[0] for r in records}:
        mine = sorted(r[4] for r in records if r[0] == name)
        theirs = sorted(ranges.get(name, []))
        assert len(theirs) == len(mine), name
        for t0, (s, e) in zip(mine, theirs):
            assert s - 1_000_000 <= t0 <= e + 1_000_000, name
    # The writer's spans nest under writer.finalize, the dense frame's
    # under the dispatch.
    parents = {(r[0], r[2]) for r in records}
    assert ("writer.fetch", "writer.finalize") in parents and ("dense.frame", "loop.dispatch") in parents
    assert ("plane.read", "dense.plane") in parents and ("loop.dispatch", None) in parents


def test_no_profiler_no_range(plain):
    """The plain run had record_function raise: no span entered it, and
    nothing was kept whole."""
    assert plain[0].loop_stats["loop.dispatch"]


def _clock(monkeypatch, ticks):
    """time.time_ns as a counter of `ticks` ns a read."""
    t = [0]

    def now():
        t[0] += ticks
        return t[0]

    monkeypatch.setattr(instrument.time, "time_ns", now)


def test_recorder_sums_self_times_and_counts(monkeypatch):
    """Nested spans on a fake clock: a duration a span and frame, the
    parent's self time less its children, counters, the kept durations,
    and zeros for a frame where a key did not fire."""
    rec = Recorder(each={"b": "b_s"})
    _clock(monkeypatch, 1000)
    with frame_scope({}, 2, rec, dispatching=True):
        with span("a"):  # reads 1 ... 8: 7 ticks
            with span("b"):  # reads 2, 3
                pass
            with span("b"):  # reads 4, 5
                pass
            with span("c"):  # reads 6, 7
                count("n", 3)
    with frame_scope({}, 0, rec):
        with span("b"):
            pass
    s = rec.stats()
    assert s["a"] == pytest.approx([0.0, 0.0, 7e-6]) and s["b"] == pytest.approx([1e-6, 0.0, 2e-6])
    assert s["c"] == pytest.approx([0.0, 0.0, 1e-6]) and s["a.self"] == pytest.approx([0.0, 0.0, 4e-6])
    assert "b.self" not in s and s["n"] == [0.0, 0.0, 3.0] and s["b_s"] == pytest.approx([1e-6, 1e-6, 1e-6])
    assert rec.records == []


def test_spans_without_a_recorder_record_nothing():
    with span("x") as sp:
        time.sleep(0.001)
    assert sp.elapsed() >= 0.001
    with frame_scope({}, 0):
        count("n")
        assert host_read(torch.ones(2), "r").tolist() == [1.0, 1.0]


def test_threads_keep_their_own_stacks_and_frames():
    """Spans on many threads at once, each in its own frame: every frame
    gets its own thread's spans, nested by its own stack; host reads count
    only in a dispatching scope."""
    rec = Recorder()

    def work(k):
        with frame_scope({}, k, rec, dispatching=k % 2 == 0):
            for _ in range(50):
                with span("outer"):
                    with span("inner"):
                        host_read(torch.zeros(1), "read")

    threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    s = rec.stats()
    assert s["host_reads"] == [50.0 if k % 2 == 0 else 0.0 for k in range(8)]
    for k in range(8):
        assert s["read"][k] <= s["inner"][k] <= s["outer"][k]
        assert s["outer.self"][k] >= 0 and s["inner.self"][k] >= 0


def test_a_long_sequence_keeps_a_few_floats_a_frame():
    """27,000 frames of 25 spans: the recorder holds one float a frame and
    key, and keeps no span whole with no profiler recording."""
    rec = Recorder()
    names = [f"s{j}" for j in range(25)]
    for i in range(27_000):
        with frame_scope({}, i, rec):
            for name in names:
                with span(name):
                    pass
    s = rec.stats()
    assert rec.records == [] and set(s) == set(names)
    assert all(len(v) == 27_000 for v in s.values())


def test_render_phases_and_counters_every_frame(plain):
    """Renders on: each frame has the four render phases and the
    counters: six images, 20 bytes a pixel with the failure map, none
    encoded on a card."""
    stats = plain[0].loop_stats
    for key in (*RENDER_SPANS, "render_bytes", "render_images"):
        assert len(stats[key]) == N_FRAMES and all(v > 0 for v in stats[key]), key
    assert stats["render_images"] == [6.0] * N_FRAMES
    assert stats["render_bytes"] == [20.0 * 192 * 256] * N_FRAMES
    assert stats["render_device_images"] == [0.0] * N_FRAMES


def test_render_phases_cover_the_render_span(plain):
    """The phases fit in writer.render frame by frame (NESTING) and cover at
    least 90% of it over the call."""
    stats = plain[0].loop_stats
    phases = sum(sum(stats[k]) for k in RENDER_SPANS)
    assert 0.9 * sum(stats["writer.render"]) <= phases <= sum(stats["writer.render"])


@pytest.mark.parametrize("failmap", [True, False], ids=["with_failure_map", "without_failure_map"])
def test_render_counters_count_the_fetched_images(tmp_path, failmap):
    """render_bytes is the uint8 bytes fetched: 20 a pixel with the
    failure map, 17 without; render_images the files written; no image
    encoded on a card."""
    h, w = 32, 48
    g = torch.Generator().manual_seed(5)
    codes = torch.randint(0, 8, (h, w), generator=g, dtype=torch.uint8)
    res = types.SimpleNamespace(disparity=torch.rand(h, w, generator=g) * 40,
                                valid=torch.rand(h, w, generator=g) > 0.5, fail_reasons=codes if failmap else None)
    extras = {"imgs": tuple(torch.randint(0, 256, (h, w), generator=g, dtype=torch.uint8) for _ in range(2)),
              "rect": tuple(torch.rand(h, w, generator=g) * 255 for _ in range(2))}
    rec = Recorder()
    with frame_scope({}, 0, rec):
        SequencePipeline._write_renders(types.SimpleNamespace(path=tmp_path), types.SimpleNamespace(roi=(2, 3, 20, 9)),
                                        res, extras)
    s = rec.stats()
    n = 6 if failmap else 5
    assert s["render_images"] == [float(n)] and len(list(tmp_path.glob("*.jpg"))) == n
    assert s["render_bytes"] == [(20.0 if failmap else 17.0) * h * w]
    assert s["render_device_images"] == [0.0]
    assert all(len(s[k]) == 1 for k in RENDER_SPANS)


def test_renders_off_record_no_render_phase(plain, norender):
    """Renders off: no render span or counter, and the benchmark's four
    readers of them read nothing; renders on, they read the spans' means."""
    off = norender.loop_stats
    assert off["writer.finalize"] and off["render_s"] == []
    assert not {"writer.render", *RENDER_SPANS, "render_bytes", "render_device_images", "render_images"} & set(off)
    on = plain[0].loop_stats
    for name, key in RENDER_READERS.items():
        read = bench_spec.metric_reader(name)
        assert read(types.SimpleNamespace(loop_stats=off)) is None, name
        scale = 1e-6 if key == "render_bytes" else 1e3
        assert read(types.SimpleNamespace(loop_stats=on)) == pytest.approx(scale * sum(on[key]) / N_FRAMES), name
    assert bench_spec.metric_reader("writers.render_mb")(types.SimpleNamespace(loop_stats=on)) == pytest.approx(
        20 * 192 * 256 / 1e6)


@pytest.mark.parametrize("loop", ["pipelined", "sharded"])
def test_two_writer_reads_a_frame(plain, sharded, loop):
    """Every frame's writer reads its export twice (the header, the payload
    rows), counted apart from the dispatching thread's one read, and the
    benchmark's reader gives their mean."""
    stats, n = (plain[0].loop_stats, N_FRAMES) if loop == "pipelined" else (sharded.loop_stats, 5)
    assert stats["writer_host_reads"] == [2.0] * n
    assert stats["host_reads"] == [1.0] * n
    read = bench_spec.metric_reader("writers.host_reads")
    assert read(types.SimpleNamespace(loop_stats=stats)) == 2.0


def test_xyzc_files_are_the_writers_old_export(seq, tmp_path, monkeypatch):
    """Each frame's mesh_cam.xyzC, from the export made with the frame and
    two reads, is byte for byte the file of the writer's old export: the
    plane read on the host, export_u16 and fetch_u16 on the writer, the
    plane's inverse transform from the host's copy."""
    pipe = _pipelined(seq, "old_export")
    pipe.cfg.debug_renders = False
    old = {}
    finalize = SequencePipeline._finalize_stereo_frame

    def keep(self, wd, geom, res, K0, K1, extras, whole):
        plane = finalize(self, wd, geom, res, K0, K1, extras, whole)
        plane32 = torch.as_tensor(res.plane.cpu().numpy().astype(np.float64), dtype=torch.float32)
        _Rp, _Tp, Rinv, Tinv = (a.numpy().astype(np.float64) for a in rt_from_plane(plane32))
        q, mins, scales = export_u16(res.points, res.valid, plane32, int(res.n_points))
        path = tmp_path / f"{wd.path.name}.xyzC"
        save_xyz_quantized(path, fetch_u16(q), scales.numpy().astype(np.float64), mins.numpy().astype(np.float64),
                           Rinv, Tinv)
        old[wd.path.name] = path.read_bytes()
        return plane

    monkeypatch.setattr(SequencePipeline, "_finalize_stereo_frame", keep)
    pipe.stereo(progress_stream=io.StringIO())
    wds = sorted(Path(pipe.outdir).glob("*_wd"))
    assert sorted(old) == [wd.name for wd in wds] and len(wds) == N_FRAMES
    for wd in wds:
        assert "windowed" in (wd / "wass_stereo_log.txt").read_text()
        assert (wd / "mesh_cam.xyzC").read_bytes() == old[wd.name], wd.name
    assert pipe.loop_stats["writer_host_reads"] == [2.0] * N_FRAMES
