"""The stereo CLI with the left-right check (DENSE_DISP12MAXDIFF >= 0):
the full-range branch with the unfused aggregation (K5's plain version)
and the WTA's left-right fold, against the JAX package's SequencePipeline
on one 256x192 frame, as in test_torch_pipeline.py."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wass_tpu.io.workdir import Workdir
from wass_tpu.io.xyzc import load_camera_mesh
from wass_tpu.stereo import dense as jd
from wass_tpu.testing import make_rig, make_scene
from wass_tpu_torch.cli.main import main as torch_main
from wass_tpu_torch.stereo import plane as tplane
from torch_registries import reset_registries  # noqa: F401  (autouse)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: the plain versions are
    thousands of small ops, and the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_picks(rounds, H, W, seed):
    k1, _ = jax.random.split(jax.random.PRNGKey(seed))
    return torch.from_numpy(np.asarray(jax.random.randint(k1, (rounds, 3, 2), 0, jnp.array([W, H]))))


def test_lr_check_sequence_matches_jax(tmp_path, monkeypatch):
    from wass_tpu.cli.main import _load_pipeline

    base = tmp_path / "base"
    rig = make_rig(width=256, height=192)
    sc = make_scene(seed=50, width=256, height=192, wave_amplitude=0.25, rig=rig)
    wd = Workdir(base / "000000_wd").create()
    wd.save_undistorted(0, sc.img0)
    wd.save_undistorted(1, sc.img1)
    wd.save_intrinsics(0, rig.K0)
    wd.save_intrinsics(1, rig.K1)
    wd.save_extrinsics(rig.R, rig.T)
    (base / "stereo_config.txt").write_text("MAX_DISPARITY=96\nDENSE_DISP12MAXDIFF=1\n")
    seq_j, seq_t = tmp_path / "jax", tmp_path / "torch"
    shutil.copytree(base, seq_j)
    shutil.copytree(base, seq_t)

    pipe = _load_pipeline(seq_j)
    assert pipe.cfg.stereo.lr_max_diff == 1
    pipe.cfg.debug_renders = False
    monkeypatch.setattr(jax, "devices", lambda *a: jax.local_devices()[:1])  # the one-device loop
    monkeypatch.setattr(jd, "_jit_triangulate", jd._jit_triangulate.__wrapped__)
    monkeypatch.setattr(jd, "_stage_plane", jd._stage_plane.__wrapped__)
    pipe.stereo()

    monkeypatch.setattr(tplane, "draw_pixels", _jax_picks)
    assert torch_main(["stereo", str(seq_t), "--device", "cpu"]) == 0
    assert "LR_MAX_DIFF=1" in (seq_t / "000000_wd" / "stereo_config.txt").read_text()

    pj = np.loadtxt(seq_j / "output" / "planes.txt", ndmin=2)
    pt = np.loadtxt(seq_t / "output" / "planes.txt", ndmin=2)
    assert pj.shape == pt.shape == (1, 4)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-4)
    mj = load_camera_mesh(seq_j / "000000_wd" / "mesh_cam.xyzC")
    mt = load_camera_mesh(seq_t / "000000_wd" / "mesh_cam.xyzC")
    assert mt.shape[1] > 1000 and np.isfinite(mt).all()
    assert abs(mt.shape[1] - mj.shape[1]) <= 0.001 * mj.shape[1]
