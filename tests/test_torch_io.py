"""The port's frame IO against the JAX package's: workdirs written by one
read back through the other (the port writes images with its own PNG
codec), and the smoke-run helpers of wass_tpu_torch.testing."""

import numpy as np
import pytest

from wass_tpu.io.workdir import Workdir
from wass_tpu.testing import make_rig, make_scene
from wass_tpu_torch.io.png import read_gray
from wass_tpu_torch.testing import load_or_make_scene, read_frame, trimmed_elevation_error, write_sequence


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_workdir_interchange(rng, tmp_path, writer):
    """A frame workdir written by either package reads back identically
    through the other: images, intrinsics, extrinsics."""
    rig = make_rig(width=40, height=24)
    img0 = rng.uniform(-20, 280, size=(24, 40)).astype(np.float32)
    img1 = rng.uniform(0, 255, size=(24, 40)).astype(np.float32)
    if writer == "port":
        wd = Workdir(write_sequence(tmp_path / "seq", img0, img1, rig, 2)[1])
        loaded = [wd.load_undistorted(cam) for cam in (0, 1)]
    else:
        wd = Workdir(tmp_path / "000000_wd").create()
        for cam, img in enumerate((img0, img1)):
            wd.save_undistorted(cam, img)
        wd.save_intrinsics(0, rig.K0)
        wd.save_intrinsics(1, rig.K1)
        wd.save_extrinsics(rig.R, rig.T)
        loaded = [read_gray(wd.undistorted_path(cam)).astype(np.float32) for cam in (0, 1)]
    for img, back in zip((img0, img1), loaded):
        np.testing.assert_array_equal(back, np.clip(img, 0, 255).astype(np.uint8).astype(np.float32))
    np.testing.assert_array_equal(wd.load_intrinsics(0), rig.K0)
    np.testing.assert_array_equal(wd.load_intrinsics(1), rig.K1)
    for a, b in zip(wd.load_extrinsics(), (rig.R, rig.T.reshape(3, 1))):
        np.testing.assert_array_equal(a, b)


def test_scene_cache_roundtrip(tmp_path):
    """load_or_make_scene renders once and then loads the same scene, one
    that scores points exactly as the freshly rendered one does."""
    a = load_or_make_scene(64, 48, 5, tmp_path)
    b = load_or_make_scene(64, 48, 5, tmp_path)
    assert len(list(tmp_path.glob("*.npz"))) == 1
    for name in ("img0", "img1", "depth0", "points0"):
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name))
    np.testing.assert_array_equal(b.rig.R, a.rig.R)
    np.testing.assert_array_equal(b.rig.T, a.rig.T)
    pts = a.points0.reshape(-1, 3)[::7] * 1.001
    plane = a.rig.plane_cam0()
    np.testing.assert_array_equal(b.elevation_error(pts, plane), a.elevation_error(pts, plane))
    np.testing.assert_array_equal(b.eta_cam0(pts), a.eta_cam0(pts))


def test_read_frame_and_elevation_error(tmp_path):
    """read_frame gives back what a finalized frame holds; the scene's own
    points score near zero on the gate."""
    sc = make_scene(seed=3, width=64, height=48, wave_amplitude=0.2)
    b = sc.rig.baseline  # the pipeline's outputs are in baseline units
    plane = sc.rig.plane_cam0() / [1, 1, 1, b]
    pts = sc.points0.reshape(-1, 3) / b
    pts = pts[np.isfinite(pts).all(axis=1)]
    Rinv, Tinv = np.eye(3), np.zeros(3)
    wd = Workdir(tmp_path / "000000_wd").create()
    wd.save_plane(plane)
    wd.save_mesh(pts, Rinv, Tinv)
    (wd.path / "wass_stereo_log.txt").write_text(
        "[INFO] kernel launches: census_cost=1 label_propagate=2 sgm_wta_fused=1\n")
    p, mesh, launches = read_frame(wd.path)
    np.testing.assert_allclose(p, plane, rtol=0, atol=1e-15)
    assert mesh.shape == pts.shape
    np.testing.assert_allclose(mesh, pts, atol=np.ptp(pts, axis=0).max() / 65535 * 2)
    assert launches == {"census_cost": 1, "label_propagate": 2, "sgm_wta_fused": 1}
    assert trimmed_elevation_error(sc, mesh, p) < 1e-3
