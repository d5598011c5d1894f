"""A whole run of a tiny cell on the CPU (the plain versions of the
kernels), skipping only the look for a card: sound, it is correct; with
the timed path broken underneath, the check comes out false."""

import bench_paths  # noqa: F401  (sys.path for the modules below)

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import cell
import tiny

BENCH = Path(__file__).resolve().parent.parent
SEED = 2**31 + 12345  # larger than 32 signed bits hold


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(tmp_path, traffic="norender", trace=False):
    return cell.run(tiny.spec(traffic), SEED, 0.5, trace, tmp_path / "work", device="cpu")


@pytest.mark.parametrize("traffic", ["norender", "cli"])
def test_a_sound_run_is_correct(tmp_path, traffic):
    r = _run(tmp_path, traffic, trace=traffic == "cli")
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 2
    assert list(r)[-1] == "checks" and all(c["value"] == 0.0 for c in r["checks"].values())
    assert ("render_gap" in r["checks"]) == (traffic == "cli")
    if traffic == "cli":
        assert {"loop.dispatch_ms", "writers.finalize_ms", "writers.render_ms", "c2f.fallback_pct"} <= set(r["metrics"])
        assert "busy_s" in r["device"] and "breakdown" in r
    else:
        assert set(r["metrics"]) == {"frames_per_s", "setup_s"}
    assert not (tmp_path / "work").exists()


def _alter_rows(monkeypatch):
    from wass_tpu_torch.cli import pipeline

    orig = pipeline.export_u16

    def altered(*a, **k):
        q, mins, scales = orig(*a, **k)
        q = q.clone()
        q[::3, 0] = (q[::3, 0] + 9).clamp(max=65535)  # x, 9 quantization steps
        return q, mins, scales

    monkeypatch.setattr(pipeline, "export_u16", altered)


def _drop_half(monkeypatch):
    from wass_tpu_torch.cli.pipeline import SequencePipeline

    orig = SequencePipeline._finalize_stereo_frame

    def half(self, wd, *a, **k):
        if int(wd.path.name.split("_")[0][-6:]) % 2 and not wd.path.name.startswith("warmup"):
            return np.full(4, np.nan)
        return orig(self, wd, *a, **k)

    monkeypatch.setattr(SequencePipeline, "_finalize_stereo_frame", half)


def _state_unchanged(monkeypatch):
    from wass_tpu_torch.stereo.dense import DenseStereoPipeline

    orig = DenseStereoPipeline.__call__
    first = {}

    def stale(self, *a, **k):
        if "res" not in first:
            first["res"] = orig(self, *a, **k)
        return first["res"]

    monkeypatch.setattr(DenseStereoPipeline, "__call__", stale)


@pytest.mark.parametrize("fault", [_alter_rows, _drop_half, _state_unchanged],
                         ids=["answer_altered", "half_the_frames_left_out", "state_unchanged"])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    fault(monkeypatch)
    r = _run(tmp_path)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def test_the_control_fails_the_check(tmp_path):
    """The reference one precision lower (TF32 products, float32 renders) in
    the program's place, its files written as the writers write them, fails
    at least one limit."""
    s = tiny.spec("cli")
    readings = cell.control_readings(s, 11, "cpu", 2, tmp_path / "control")
    ok, checks = cell.compare.verdict(cell.compare.worst(readings), s["limits"])
    assert ok is False
    assert checks["plane_gap"]["value"] > checks["plane_gap"]["limit"]
    assert not (tmp_path / "control").exists()


def test_the_run_loads_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]; import cell, spec, trace, compare; "
            "from wass_tpu_torch.cli.main import load_pipeline; "
            "from wass_tpu_torch.cli import pipeline; print(cell.forbidden_modules())") % (str(BENCH), str(BENCH.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True).stdout
    assert out.strip() == "[]"


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "stereo-3mp-norender", "--seed",
                           str(SEED), "--seconds", "2", "--trace", "0"], capture_output=True, text=True,
                          cwd=BENCH.parent, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
    assert r["metrics"]["frames_per_s"]["value"] > 0
