"""Port parity of the delta-coded .xyzC wire (stereo/dense.export_delta,
cli/pipeline.SequencePipeline's wire_delta) against the JAX package's
_stage_export_delta and its AUTO decision (tests/test_pipeline_e2e.py's
TestWireDeltaAuto on the port)."""

import io
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wass_tpu.stereo import dense as jd
from wass_tpu_torch.cli.pipeline import SequenceConfig, SequencePipeline
from wass_tpu_torch.io.xyzc import decode_delta_payload
from wass_tpu_torch.stereo import dense as td


def _surface(rng, H, W, hole_share, jump=False):
    """A point grid (x, y 0.01 apart a pixel; z a slope across the rows, a
    gentle wave along them and noise), with a share of invalid pixels and
    optionally a depth discontinuity, and a plane near it.  On a wide grid
    a pixel's step along a row is under 127 quanta in every component, as
    on a production-width frame; on a narrow one it is not."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    z = 10 + 2.0 * yy / H + 0.01 * np.sin(xx / 20.0) * np.cos(yy / 7.0) + rng.normal(0, 1e-4, (H, W))
    if jump:
        z[H // 3:H // 2, W // 4:W // 2] += 2.0
    pts = np.stack([xx * 0.01, yy * 0.01, z], -1).astype(np.float32)
    valid = rng.random((H, W)) >= hole_share
    n = np.array([0.01, -0.02, 1.0])
    plane = np.append(n / np.linalg.norm(n), -10.0).astype(np.float32)
    return pts, valid, plane


CASES = {"wide_smooth": (24, 640, 0.0, False), "wide_speckled": (24, 640, 0.25, True), "narrow": (32, 96, 0.1, False)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_export_delta_matches_jax(rng, case):
    """export_delta over the whole H*W buffers is bit-equal to the JAX
    package's _stage_export_delta: the biased deltas, the compacted
    exception rows, the u16 rows, the exception count, mins and scales;
    the host decode of its first n_exc exception rows gives exactly
    export_u16's rows."""
    H, W, holes, jump = CASES[case]
    pts, valid, plane = _surface(rng, H, W, holes, jump)
    ref = jd._stage_export_delta(jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(plane))
    out = td.export_delta(torch.from_numpy(pts), torch.from_numpy(valid), torch.from_numpy(plane), H * W)
    assert out[0].dtype == torch.uint8
    for name, a, b in zip(("delta_b", "exc_vals", "q", "n_exc", "mins", "scales"), ref, out):
        a = np.asarray(a)
        assert b.shape == a.shape, name
        np.testing.assert_array_equal(b.numpy().astype(np.float64), a.astype(np.float64), err_msg=name)
    n = int(valid.sum())
    delta_b, exc_vals, q, n_exc, _, _ = td.export_delta(torch.from_numpy(pts), torch.from_numpy(valid),
                                                        torch.from_numpy(plane), n)
    assert int(n_exc) == int(ref[3])
    rows, _, _ = td.export_u16(torch.from_numpy(pts), torch.from_numpy(valid), torch.from_numpy(plane), n)
    decoded = decode_delta_payload(delta_b.numpy(), td.fetch_u16(exc_vals[:int(n_exc)]))
    np.testing.assert_array_equal(decoded, td.fetch_u16(rows))
    np.testing.assert_array_equal(td.fetch_u16(q), np.asarray(ref[2])[:n])
    print(f"{case}: {int(n_exc)} exception rows of {n}")


@pytest.mark.parametrize("case,branch", [("wide_smooth", "delta-coded"), ("narrow", "direct")])
def test_fetch_delta_branches(rng, case, branch):
    """The finalizer's wire: a wide smooth frame ships delta-coded (fewer
    than a quarter of its rows are exceptions), a narrow frame (a pixel
    step above 127 quanta in x) ships direct; both give export_u16's
    rows."""
    H, W, holes, jump = CASES[case]
    pts, valid, plane = _surface(rng, H, W, holes, jump)
    res = td.DenseFrameResult(points=torch.from_numpy(pts), valid=torch.from_numpy(valid), plane=None, plane_ok=None,
                              disparity=None, n_points=None)
    n = int(valid.sum())
    quant, mins, scales, line = SequencePipeline._fetch_delta(res, torch.from_numpy(plane), n)
    assert line.startswith(f"wire: {branch}")
    rows, mins_u, scales_u = td.export_u16(res.points, res.valid, torch.from_numpy(plane), n)
    np.testing.assert_array_equal(quant, td.fetch_u16(rows))
    assert torch.equal(mins, mins_u) and torch.equal(scales, scales_u)


def test_fetch_u16_keeps_every_value():
    q = torch.tensor([[0, 1, 32767], [32768, 65534, 65535]], dtype=torch.int32)
    out = td.fetch_u16(q)
    assert out.dtype == np.uint16 and out.tolist() == q.tolist()


def test_wire_delta_run_writes_the_direct_files(tmp_path):
    """stereo() with wire_delta=True writes .xyzC files byte-equal to a
    direct run's, and logs the wire of each frame."""
    from wass_tpu_torch.testing import make_scene, write_sequence

    sc = make_scene(seed=5, width=96, height=64, wave_amplitude=0.25)
    cfg = td.DenseStereoConfig(num_disp=16, plane_ransac_rounds=64)
    files = {}
    for delta in (False, True):
        root = tmp_path / str(delta)
        write_sequence(root, sc.img0, sc.img1, sc.rig, 2)
        pipe = SequencePipeline(root, SequenceConfig(stereo=cfg, device="cpu", wire_delta=delta, debug_renders=False))
        pipe.stereo(progress_stream=io.StringIO())
        files[delta] = [p.read_bytes() for p in sorted(root.glob("*_wd/mesh_cam.xyzC"))]
        logs = [p.read_text() for p in sorted(root.glob("*_wd/wass_stereo_log.txt"))]
        assert all(("wire:" in log) == delta for log in logs)
    assert len(files[True]) == 2 and files[True] == files[False]


def test_break_even_flips():
    """tests/test_pipeline_e2e.py:TestWireDeltaAuto's cases: delta on a
    slow link and a fast host, direct on a fast link."""
    d = SequencePipeline._wire_delta_decision
    assert d(28.0, 4e-7) is False
    assert d(1.0, 4e-7) is True
    assert d(2000.0, 1e-7) is False


def test_probe_returns_rates_and_a_decision(tmp_path):
    """The probe measures a positive link rate and decode time on the
    device it is given (here the CPU); AUTO resolves once a sequence."""
    down, decode = SequencePipeline._probe_wire_rates("cpu")
    assert down > 0 and 0 < decode < 1e-3
    assert SequencePipeline._probe_wire_delta("cpu") in (True, False)
    from wass_tpu_torch.testing import make_scene, write_sequence

    sc = make_scene(seed=5, width=96, height=64, wave_amplitude=0.25)
    write_sequence(tmp_path, sc.img0, sc.img1, sc.rig, 1)
    pipe = SequencePipeline(tmp_path, SequenceConfig(stereo=td.DenseStereoConfig(num_disp=16, plane_ransac_rounds=32),
                                                     device="cpu", debug_renders=False))
    assert pipe.cfg.wire_delta is None
    pipe.stereo(progress_stream=io.StringIO())
    assert pipe.cfg.wire_delta in (True, False)
    assert (Path(tmp_path) / "000000_wd" / "mesh_cam.xyzC").exists()
