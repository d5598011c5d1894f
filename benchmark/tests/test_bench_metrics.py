"""The metric arithmetic on recorded inputs: the SGM bound from a launch
line, the idle share and gaps from a made-up timeline, the fallback share
from sample logs."""

import bench_paths  # noqa: F401  (sys.path for the modules below)

import types
from pathlib import Path

import numpy as np
import pytest

import cell
import peaks
import spec as spec_mod
import trace as trace_mod
from reference import options

PEAKS = {"bytes_per_s": 3.35e12, "ops_per_s": 132 * 256 * 1.98e9}
LAUNCH = ("kernel launches: census_cost=1 census_cost_windowed=1 label_propagate=1 sgm_aggregate=0 "
          "sgm_aggregate_windowed=0 sgm_pair_img=0 sgm_walk=0 sgm_wta_fused=1 sgm_wta_fused_windowed=1")


def _log(tmp_path: Path, name: str, lines) -> Path:
    p = tmp_path / name
    p.write_text("".join(f"[INFO] {ln}\n" for ln in lines))
    return p


def test_parse_log_reads_the_writer_lines(tmp_path):
    p = _log(tmp_path, "a.txt", [LAUNCH, "c2f window coverage: 0.9981 coherent-offband: 0.00001 windowed",
                                 "triangulated+filtered points: 2731451", "finalize wall time: 0.123s"])
    info = cell.parse_log(p)
    assert info["launches"]["sgm_wta_fused"] == 1 and info["fallback"] is False
    assert info["finalize_s"] == pytest.approx(0.123)


def test_fallback_share_from_logs(tmp_path):
    frames = []
    for i, verdict in enumerate(["windowed", "FALLBACK to full-range SGM", "windowed", "windowed"]):
        frames.append(cell.parse_log(_log(tmp_path, f"{i}.txt", [LAUNCH, f"c2f window coverage: 0.4 coherent-offband: 0.0 {verdict}"])))
    read = spec_mod.metric_reader("c2f.fallback_pct")
    assert read(types.SimpleNamespace(frames=frames)) == pytest.approx(25.0)
    assert read(types.SimpleNamespace(frames=[{"fallback": None}])) is None


def _sgm_ctx(frames, kernel_s):
    cfg = options.stereo_config({})
    trace = {"by_name": {"void sgm_path_kernel<4, 2>(...)": kernel_s, "census_kernel": 1.0}, "busy_s": 1.0,
             "window_s": 2.0}
    return types.SimpleNamespace(trace=trace, peaks=PEAKS, stereo=cfg, shape=(1536, 2048), frames=frames)


def test_sgm_roofline_from_a_launch_line():
    frame = {"launches": {"sgm_wta_fused": 1, "sgm_wta_fused_windowed": 1},
             "fallback": False}
    read = spec_mod.metric_reader("kernels.sgm_roofline")
    # coarse K3: 384 x 512 x 160 with 8 paths; K4: 1536 x 2048 x 128 with 8 paths.
    ops = (7 * 8 + 1) * (384 * 512 * 160 + 1536 * 2048 * 128)
    least = ops / PEAKS["ops_per_s"]  # operations bind at both shapes
    assert read(_sgm_ctx([frame], 0.010)) == pytest.approx(100 * least / 0.010)
    # A fallback frame adds a full-range K3 at D = 640.
    fb = {"launches": {"sgm_wta_fused": 2, "sgm_wta_fused_windowed": 1}, "fallback": True}
    extra = (7 * 8 + 1) * 1536 * 2048 * 640 / PEAKS["ops_per_s"]
    assert read(_sgm_ctx([frame, fb], 0.050)) == pytest.approx(100 * (2 * least + extra) / 0.050)
    assert read(_sgm_ctx([frame], 0.0)) is None


def test_least_seconds_names_the_binding_bound():
    assert peaks.least_seconds(3.35e12, 1.0, PEAKS) == (1.0, "bytes")
    assert peaks.least_seconds(1.0, PEAKS["ops_per_s"] * 2, PEAKS) == (2.0, "operations")


def test_idle_share_and_gaps_from_a_timeline():
    ms = 1_000_000
    window = (0, 100 * ms, 1)
    device = [(10 * ms, 30 * ms, "k1"), (20 * ms, 40 * ms, "k2"), (60 * ms, 70 * ms, "k1"), (150 * ms, 160 * ms, "late")]
    host = [(0, 100 * ms, "outer", 1), (45 * ms, 58 * ms, "aten::linalg_eigh", 1), (72 * ms, 99 * ms, "w", 2)]
    s = trace_mod.reduce(window, host, device)
    assert s["window_s"] == pytest.approx(0.1) and s["busy_s"] == pytest.approx(0.04)
    assert dict(s["device_ops"]) == pytest.approx({"k1": 0.03, "k2": 0.02})
    gaps = s["idle_gaps"]
    assert [round(g[1], 6) for g in gaps] == [0.03, 0.02, 0.01]
    assert gaps[1][0] == "aten::linalg_eigh"  # 40-60 ms: the dispatching thread's innermost op
    assert gaps[0][0] == "outer"
    read = spec_mod.metric_reader("device.idle_pct")
    assert read(types.SimpleNamespace(trace=s)) == pytest.approx(60.0)
    busy = spec_mod.metric_reader("device.busy_ms")
    assert busy(types.SimpleNamespace(trace=s, n_frames=4)) == pytest.approx(10.0)


def test_loop_stats_means():
    ctx = types.SimpleNamespace(loop_stats={"dispatch_s": [0.1, 0.3], "decode_s": [0.02] * 4, "render_s": []},
                                frames=[{"finalize_s": 0.2}, {"finalize_s": 0.4}])
    assert spec_mod.metric_reader("loop.dispatch_ms")(ctx) == pytest.approx(200.0)
    assert spec_mod.metric_reader("prefetch.decode_ms")(ctx) == pytest.approx(20.0)
    assert spec_mod.metric_reader("writers.finalize_ms")(ctx) == pytest.approx(300.0)
    assert spec_mod.metric_reader("writers.render_ms")(ctx) is None


def test_window_frames_rounds_and_caps():
    # 37.5 megapixels a second over 3.146 megapixels x 10 s: 119.2 frames, 15 cycles of 8.
    assert cell.window_frames(10, 8, 37.5, 2048 * 1536 / 1e6, 16e6, 3e9) == (120, False)
    assert cell.window_frames(10, 8, 37.5, 2048 * 1536 / 1e6, 40e6, 3e9) == (72, True)
    assert cell.window_frames(10, 8, 0.0, 2048 * 1536 / 1e6, 16e6, 3e9) == (8, False)


def test_compared_frames_alternate_parity_over_distinct_pairs():
    for seed in range(20):
        rng = np.random.default_rng(seed)
        chosen = cell.compared_frames(rng, 120, 8, 2)
        assert len(chosen) == 2 and {i % 2 for i in chosen} == {0, 1}
        assert len({i % 8 for i in chosen}) == 2 and all(0 <= i < 120 for i in chosen)
    assert cell.compared_frames(np.random.default_rng(0), 2, 2, 2) == [0, 1]
