"""Port parity of the sequence stereo stage: `wass-tpu-torch stereo` (CPU,
plain versions) vs the JAX package's SequencePipeline.stereo over a 2-frame
256x192 sequence built as in .claude/skills/verify/SKILL.md.
The debug renders are on in both (the same file names in each workdir).

Both packages draw the same RANSAC pixel picks (the port's draw is replaced
by the JAX one), and the JAX float stages run op by op (see
test_torch_dense.py)."""

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
from wass_tpu_torch.cli.pipeline import SequenceConfig, SequencePipeline
from wass_tpu_torch.stereo import plane as tplane
from torch_registries import reset_registries  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    root = tmp_path_factory.mktemp("seq")
    rig = make_rig(width=256, height=192)
    for i in range(2):
        sc = make_scene(seed=50 + i, width=256, height=192, wave_amplitude=0.25, rig=rig, time=i * 0.2)
        wd = Workdir(root / "base" / f"{i:06d}_wd").create()
        wd.save_undistorted(0, sc.img0)
        wd.save_undistorted(1, sc.img1)
        wd.save_intrinsics(0, rig.K0)
        wd.save_intrinsics(1, rig.K1)
        wd.save_extrinsics(rig.R, rig.T)
    (root / "base" / "stereo_config.txt").write_text("MAX_DISPARITY=96\n")
    return root


def _jax_picks(rounds, H, W, seed):
    k1, _ = jax.random.split(jax.random.PRNGKey(seed))
    return torch.from_numpy(np.asarray(jax.random.randint(k1, (rounds, 3, 2), 0, jnp.array([W, H]))))


def _planes(seq):
    return np.loadtxt(seq / "output" / "planes.txt", ndmin=2)


def test_sequence_stereo_matches_jax(sequence, monkeypatch):
    from wass_tpu.cli.main import _load_pipeline

    seq_j, seq_t = sequence / "jax", sequence / "torch"
    shutil.copytree(sequence / "base", seq_j)
    shutil.copytree(sequence / "base", seq_t)

    pipe = _load_pipeline(seq_j)  # debug renders on, as in the port
    monkeypatch.setattr(jax, "devices", lambda *a: jax.local_devices()[:1])  # the one-device loop
    monkeypatch.setattr(jd, "_jit_triangulate", jd._jit_triangulate.__wrapped__)
    monkeypatch.setattr(jd, "_stage_plane", jd._stage_plane.__wrapped__)
    pipe.stereo()

    monkeypatch.setattr(tplane, "draw_pixels", _jax_picks)
    assert torch_main(["stereo", str(seq_t), "--device", "cpu"]) == 0

    pj, pt = _planes(seq_j), _planes(seq_t)
    assert pj.shape == pt.shape == (2, 4)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-4)
    for i in range(2):
        name = f"{i:06d}_wd"
        mj = load_camera_mesh(seq_j / name / "mesh_cam.xyzC")
        mt = load_camera_mesh(seq_t / name / "mesh_cam.xyzC")
        assert mt.shape[0] == 3 and np.isfinite(mt).all()
        assert abs(mt.shape[1] - mj.shape[1]) <= 0.001 * mj.shape[1]
        assert (seq_t / name / "plane.txt").exists() and (seq_t / name / "P1cam.txt").exists()
        renders = sorted(p.name for p in (seq_t / name).glob("*.jpg"))
        assert len(renders) == 6 and renders == sorted(p.name for p in (seq_j / name).glob("*.jpg"))
        log = (seq_t / name / "wass_stereo_log.txt").read_text()
        assert ("kernel launches: census=0 census_cost=0 census_cost_windowed=0 label_propagate=0 sgm_aggregate=0 "
                "sgm_aggregate_windowed=0 sgm_pair_img=0 sgm_tri_dir_partial_h2=0 "
                "sgm_tri_dir_partial_windowed_h2=0 sgm_tri_dir_wta_h2=0 sgm_tri_dir_wta_windowed_h2=0 "
                "sgm_walk=0 sgm_wta_fused=0 sgm_wta_fused_windowed=0") in log


def test_min_triangulated_gate(sequence, tmp_path):
    """A frame below MIN_TRIANGULATED_POINTS gets a nan plane and an empty
    mesh, and the sequence goes on."""
    seq = tmp_path / "gate"
    shutil.copytree(sequence / "base", seq)
    (seq / "stereo_config.txt").write_text("MAX_DISPARITY=96\nMIN_TRIANGULATED_POINTS=100000000\n")
    assert torch_main(["stereo", str(seq), "--device", "cpu"]) == 0
    assert "nan" in (seq / "000000_wd" / "plane.txt").read_text()
    assert load_camera_mesh(seq / "000001_wd" / "mesh_cam.xyzC").shape == (3, 0)
    assert (seq / "output" / "planes.txt").read_text() == ""


def test_cuda_device_required(sequence):
    """No fallback: asking for the card without one raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    pipe = SequencePipeline(sequence / "base", SequenceConfig(device="cuda"))
    with pytest.raises(RuntimeError, match="CUDA"):
        pipe.stereo()
