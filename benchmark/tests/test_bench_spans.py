"""The readers of the stereo loop's spans and counters on a made-up
loop_stats: the means over the window's frames, the launch cost less the
plane's host read, and nothing where the program left no such key (as a
program without the spans leaves none)."""

import bench_paths  # noqa: F401  (sys.path for the modules below)

import types

import pytest

import spec as spec_mod

# Two frames' spans in seconds, one counter.
STATS = {
    "loop.take": [0.001, 0.003],
    "loop.rig": [0.002, 0.004],
    "loop.upload": [0.001, 0.001],
    "loop.rectify": [0.002, 0.002],
    "dense.frame": [0.050, 0.070],
    "plane.read": [0.010, 0.030],
    "loop.dispatch.cpu": [0.040, 0.060],
    "host_reads": [1.0, 1.0],
    "loop.writer_wait": [0.0, 0.008],
    "writer.device_wait": [0.020, 0.024],
    "writer.fetch": [0.011, 0.013],
}
SIMPLE = {
    "prefetch.wait_ms": ("loop.take", 2.0),
    "loop.rig_ms": ("loop.rig", 3.0),
    "loop.sync_wait_ms": ("plane.read", 20.0),
    "loop.dispatch_cpu_ms": ("loop.dispatch.cpu", 50.0),
    "loop.host_reads": ("host_reads", 1.0),
    "loop.writer_wait_ms": ("loop.writer_wait", 4.0),
    "writers.device_wait_ms": ("writer.device_wait", 22.0),
    "writers.fetch_ms": ("writer.fetch", 12.0),
}


def _ctx(stats):
    return types.SimpleNamespace(loop_stats=stats, frames=[], trace=None, n_frames=2)


@pytest.mark.parametrize("name", sorted(SIMPLE))
def test_mean_over_the_frames(name):
    key, mean = SIMPLE[name]
    read = spec_mod.metric_reader(name)
    assert read(_ctx(STATS)) == pytest.approx(mean)
    assert read(_ctx({k: v for k, v in STATS.items() if k != key})) is None
    assert read(_ctx({**STATS, key: []})) is None


def test_launch_cost_leaves_out_the_plane_read():
    read = spec_mod.metric_reader("loop.launch_ms")
    # Frame 0: 1 + 2 + 50 - 10 ms; frame 1: 1 + 2 + 70 - 30 ms.
    assert read(_ctx(STATS)) == pytest.approx((43.0 + 43.0) / 2)
    for key in ("loop.upload", "loop.rectify", "dense.frame", "plane.read"):
        assert read(_ctx({k: v for k, v in STATS.items() if k != key})) is None
        assert read(_ctx({**STATS, key: []})) is None


def test_the_parts_add_up_to_the_dispatch():
    """rig + launch + the host read + the rest of the dispatch (submit and
    the dispatch's self time) is the dispatch, frame by frame."""
    submit, own = [0.0005, 0.0007], [0.0001, 0.0002]
    dispatch = [r + u + c + f + s + o for r, u, c, f, s, o in
                zip(STATS["loop.rig"], STATS["loop.upload"], STATS["loop.rectify"], STATS["dense.frame"], submit, own)]
    ctx = _ctx({**STATS, "dispatch_s": dispatch})
    parts = sum(spec_mod.metric_reader(n)(ctx) for n in ("loop.rig_ms", "loop.launch_ms", "loop.sync_wait_ms"))
    whole = spec_mod.metric_reader("loop.dispatch_ms")(ctx)
    assert parts + 1e3 * (sum(submit) + sum(own)) / 2 == pytest.approx(whole)


def test_a_program_without_spans_reads_nothing():
    ctx = _ctx({"dispatch_s": [0.1], "decode_s": [0.02, 0.03], "render_s": []})
    for name in [*SIMPLE, "loop.launch_ms"]:
        assert spec_mod.metric_reader(name)(ctx) is None
