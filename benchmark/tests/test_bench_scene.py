"""The frozen input generator traces what the port's render_pair traces."""

import bench_paths  # noqa: F401  (sys.path for the modules below)

import numpy as np
import torch

import scene
from wass_tpu_torch.testing import synthetic


def test_generator_equals_render_pair_at_time_zero():
    rig = scene.make_rig(128, 96)
    port_rig = synthetic.make_rig(width=128, height=96)
    for k in ("K0", "K1", "R0", "T0", "R1", "T1"):
        np.testing.assert_array_equal(getattr(rig, k), getattr(port_rig, k))
    img0, img1, pts = scene.Sea(7, rig, "cpu", 0.25).pair(0.0, with_points=True)
    want0, want1 = synthetic.render_pair(7, port_rig, "cpu", wave_amplitude=0.25)
    np.testing.assert_array_equal(img0, want0)
    np.testing.assert_array_equal(img1, want1)
    # The ground truth is make_scene's per-pixel camera-0 points.
    sc = synthetic.make_scene(seed=7, width=128, height=96, wave_amplitude=0.25, rig=port_rig)
    np.testing.assert_allclose(pts.numpy(), sc.points0, rtol=0, atol=1e-9, equal_nan=True)


def test_time_moves_the_waves_not_the_texture():
    rig = scene.make_rig(64, 48)
    sea = scene.Sea(3, rig, "cpu", 0.25)
    a = sea.pair(0.0)[0]
    b = sea.pair(1 / 15)[0]
    assert not np.array_equal(a, b)
    assert np.abs(a - b).mean() < 0.25 * np.abs(a - a.mean()).mean()
    np.testing.assert_array_equal(a, sea.pair(0.0)[0])


def test_elevation_error_of_the_ground_truth_is_zero():
    rig = scene.make_rig(64, 48)
    _, _, pts = scene.Sea(5, rig, "cpu", 0.25).pair(0.0, with_points=True)
    P = pts.numpy().reshape(-1, 3)
    P = P[np.isfinite(P).all(1)][::7] / rig.baseline
    plane = np.array([0.0, -0.4, 0.9, -3.0])
    assert scene.elevation_error(pts, rig.K0, rig.baseline, P, plane) < 1e-5
    assert torch.is_tensor(pts)
