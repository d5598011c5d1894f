"""A cell small enough for the CPU: the benchmark's tests drive the whole
run at 256x192 with the plain versions of the kernels."""

import bench_paths  # noqa: F401

import copy
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
# The renders' metric of the stereo-5mp cell, whose files the benchmark keeps
# for a later PR to add its BENCHMARK.json entries (PERF.md, Open questions).
RENDER_MS = [{"name": "writers.render_ms", "unit": "ms", "better": "lower", "source": "program_span",
              "layer": "writers' renders", "moves": "frames_per_s"}]


def spec(traffic: str = "norender", frames: int = 2) -> dict:
    """wass-3mp's settings at 256x192 with MAX_DISPARITY 160 (c2f still
    runs: H a multiple of 32, the window 128 inside the range), one cycle
    of `frames` pairs, a warm-up and a window of as many frames."""
    config = json.loads((BENCH / "configs" / "wass-3mp.json").read_text())
    config.update(width=256, height=192)
    config["stereo"] = dict(config["stereo"], MAX_DISPARITY=160)
    tr = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
    tr.update(pairs=frames, warmup_frames=frames, compare_frames=frames, window_megapixels_per_s=0.0)
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    cell = {"name": "tiny", "config": "tiny", "traffic": traffic, "chips": 1}
    limits = json.loads((BENCH / "limits" / "wass-3mp.json").read_text())
    return {"cell": cell, "config": config, "traffic": tr, "limits": copy.deepcopy(limits),
            "end_to_end": bench["end_to_end"],
            "per_layer": [m for m in bench["per_layer"] if "workloads" not in m] + (RENDER_MS if traffic == "cli" else [])}
