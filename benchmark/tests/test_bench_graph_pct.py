"""The reader of the share of frames replayed from CUDA graphs, on made-up
loop_stats: the mean of the counter over the window's frames, and nothing
where the program keeps no such counter."""

import bench_paths  # noqa: F401  (sys.path for the modules below)

import types

import pytest

import spec as spec_mod


def _ctx(stats):
    return types.SimpleNamespace(loop_stats=stats, frames=[], trace=None, n_frames=4)


@pytest.mark.parametrize("replays,share", [([1.0, 1.0, 1.0, 1.0], 100.0), ([1.0, 0.0, 1.0, 0.0], 50.0),
                                           ([0.0, 0.0], 0.0)])
def test_graph_share(replays, share):
    read = spec_mod.metric_reader("loop.graph_pct")
    assert read(_ctx({"dense_graph_replays": replays, "dense_graph_captures": [1.0] * len(replays)})) == \
        pytest.approx(share)


def test_no_counter_reads_nothing():
    read = spec_mod.metric_reader("loop.graph_pct")
    assert read(_ctx({"dispatch_s": [0.1], "host_reads": [1.0]})) is None
    assert read(_ctx({"dense_graph_replays": []})) is None
