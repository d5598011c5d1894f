"""What one cell is made of, found by name: BENCHMARK.json's entries, the
configuration's file, the traffic mix's file, the limits of the
correctness check and a reader for each per-layer metric.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own, so that a cell, a
configuration, a mix or a metric is added by adding files and entries:

  configs/<config>.json        the configuration as it is run
  traffic/<traffic>.json       the mix's parameters, read by cell.py
  limits/<config>.json         the limit of each compared number
  metrics/<metric name>.py     read(ctx) -> float or None
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path) -> dict:
    return json.loads(Path(path).read_text())


def metric_reader(name: str, metrics_dir: Path = HERE / "metrics"):
    """The read(ctx) function of metrics/<name>.py."""
    path = metrics_dir / f"{name}.py"
    spec = importlib.util.spec_from_file_location("bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(workload: str, root: Path = ROOT) -> dict:
    """The resolved description of one cell of root/BENCHMARK.json."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[cell["config"]]
    return {
        "cell": cell,
        "config": load_json(root / entry["file"]),
        "traffic": load_json(root / "benchmark" / "traffic" / f"{cell['traffic']}.json"),
        "limits": load_json(root / "benchmark" / "limits" / f"{cell['config']}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m, workload)],
        "per_layer": [m for m in bench["per_layer"] if applies(m, workload)],
    }
