"""The .xyzC comparison script (wass_tpu_torch/testing/xyzc_diff.py) on
files written by the port's .xyzC writer."""

import numpy as np

from wass_tpu_torch.io.xyzc import save_xyz_quantized
from wass_tpu_torch.testing import xyzc_diff


def _write(path, q, scales=(1.0, 2.0, 3.0)):
    path.parent.mkdir(parents=True, exist_ok=True)
    save_xyz_quantized(path, q, scales, (0.0, 0.0, 0.0), np.eye(3), np.zeros(3))


def test_compare_reports_payload_and_header(tmp_path, rng):
    q = rng.integers(0, 65536, (50, 3)).astype(np.uint16)
    q2 = q.copy()
    q2[7, 2] = q[7, 2] + 1 if q[7, 2] < 65535 else q[7, 2] - 1
    _write(tmp_path / "a.xyzC", q)
    _write(tmp_path / "b.xyzC", q2)
    _write(tmp_path / "c.xyzC", q, scales=(1.0, 2.0, 3.5))
    _write(tmp_path / "d.xyzC", q[:40])
    r = xyzc_diff.compare(tmp_path / "a.xyzC", tmp_path / "b.xyzC")
    assert r == {"points": (50, 50), "header_equal": True, "max_u16_diff": 1}
    assert xyzc_diff.compare(tmp_path / "a.xyzC", tmp_path / "c.xyzC")["header_equal"] is False
    assert xyzc_diff.compare(tmp_path / "a.xyzC", tmp_path / "d.xyzC")["max_u16_diff"] is None


def test_main_walks_both_trees(tmp_path, rng, capsys):
    q = rng.integers(0, 65536, (20, 3)).astype(np.uint16)
    for run, delta in (("a", 0), ("b", 3)):
        _write(tmp_path / run / "seq" / "000000_wd" / "mesh_cam.xyzC", q)
        _write(tmp_path / run / "seq" / "000001_wd" / "mesh_cam.xyzC", np.minimum(q.astype(np.int32) + delta, 65535))
    assert xyzc_diff.main([str(tmp_path / "a"), str(tmp_path / "b")]) == 0
    out = capsys.readouterr().out
    assert "2 files" in out and "largest u16 difference 3" in out
    assert xyzc_diff.main([str(tmp_path / "a"), str(tmp_path / "none")]) == 1
