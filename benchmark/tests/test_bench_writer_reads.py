"""The reader of the writers' host reads (writers.host_reads) on a made-up
loop_stats: the mean of the counter over the window's frames, reported in
every cell, and nothing where the program keeps no such counter (as a
program whose writers read through no counted host read keeps none)."""

import bench_paths  # noqa: F401  (sys.path for the modules below)

import json
import types

import pytest

import spec as spec_mod

NAME = "writers.host_reads"


def _ctx(stats):
    return types.SimpleNamespace(loop_stats=stats, frames=[], trace=None, n_frames=2)


@pytest.mark.parametrize("reads,mean", [([2.0, 2.0, 2.0], 2.0), ([2.0, 5.0, 1.0, 2.0], 2.5)],
                         ids=["two_a_frame", "a_rerun_and_a_failed_frame"])
def test_mean_over_the_frames(reads, mean):
    stats = {"host_reads": [1.0] * len(reads), "writer_host_reads": reads, "writer.fetch": [0.002] * len(reads)}
    assert spec_mod.metric_reader(NAME)(_ctx(stats)) == pytest.approx(mean)


@pytest.mark.parametrize("stats", [{"host_reads": [1.0, 1.0], "writer.fetch": [0.06, 0.07]},
                                   {"host_reads": [1.0], "writer_host_reads": []}],
                         ids=["no_counter", "no_frame"])
def test_a_program_without_the_counter_reads_nothing(stats):
    assert spec_mod.metric_reader(NAME)(_ctx(stats)) is None


def test_every_cell_reports_it():
    bench = json.loads((spec_mod.ROOT / "BENCHMARK.json").read_text())
    entry = [m for m in bench["per_layer"] if m["name"] == NAME]
    assert len(entry) == 1 and entry[0]["layer"] == "writers" and entry[0]["moves"] == "frames_per_s"
    for w in bench["workloads"]:
        assert NAME in [m["name"] for m in spec_mod.load(w["name"])["per_layer"]]
