"""Cells, configurations, mixes, limits and metrics are found by name, and
a new one is added by adding files and BENCHMARK.json entries only."""

import bench_paths  # noqa: F401  (sys.path for the modules below)

import hashlib
import json
import shutil
from pathlib import Path

import pytest

import spec as spec_mod

BENCH = Path(spec_mod.__file__).resolve().parent
ROOT = BENCH.parent


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", [w["name"] for w in _bench()["workloads"]])
def test_every_cell_loads_by_name(workload):
    s = spec_mod.load(workload, ROOT)
    assert s["config"]["name"] == s["cell"]["config"]
    assert {m["name"] for m in s["end_to_end"]} >= {"frames_per_s", "setup_s"}
    for m in s["per_layer"]:
        assert callable(spec_mod.metric_reader(m["name"]))
    assert set(s["limits"]) >= {"plane_gap", "mesh_gap", "rows_off", "frames_missing"}


def test_every_per_layer_metric_has_its_file():
    """Each metric of BENCHMARK.json has its reader; a reader kept for a cell
    not yet in BENCHMARK.json (writers.render_ms, stereo-5mp's) loads too."""
    names = {m["name"] for m in _bench()["per_layer"]}
    files = {p.name[:-3] for p in (BENCH / "metrics").glob("*.py")}
    assert names <= files and files - names == {"writers.render_ms"}
    assert all(callable(spec_mod.metric_reader(f)) for f in files)


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_adding_a_cell_edits_no_file(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _digests(root / "benchmark")
    b = json.loads((root / "BENCHMARK.json").read_text())
    # A new configuration, mix, limits, metric and cell: files and entries only.
    cfg = json.loads((root / "benchmark/configs/wass-3mp.json").read_text())
    cfg.update(name="wass-new", width=1024, height=768)
    (root / "benchmark/configs/wass-new.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "benchmark/traffic/norender.json").read_text())
    mix["pairs"] = 4
    (root / "benchmark/traffic/fourpairs.json").write_text(json.dumps(mix))
    (root / "benchmark/limits/wass-new.json").write_text((root / "benchmark/limits/wass-3mp.json").read_text())
    (root / "benchmark/metrics/loop.frames_n.py").write_text("def read(ctx):\n    return float(ctx.n_frames)\n")
    b["configs"].append({"name": "wass-new", "source": "s", "file": "benchmark/configs/wass-new.json",
                         "reduced": [], "why": "w"})
    b["workloads"].append({"name": "new-cell", "config": "wass-new", "traffic": "fourpairs", "chips": 1, "why": "w"})
    b["per_layer"].append({"name": "loop.frames_n", "unit": "frames", "better": "higher", "source": "program_counter",
                           "layer": "sequence loop", "moves": "frames_per_s", "workloads": ["new-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    s = spec_mod.load("new-cell", root)
    assert s["config"]["width"] == 1024 and s["traffic"]["pairs"] == 4
    assert "loop.frames_n" in [m["name"] for m in s["per_layer"]]
    read = spec_mod.metric_reader("loop.frames_n", root / "benchmark" / "metrics")
    assert read(type("ctx", (), {"n_frames": 7})()) == 7.0
    after = _digests(root / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before
    # The old cells still load as they did.
    assert spec_mod.load("stereo-3mp-norender", root)["config"]["name"] == "wass-3mp"
