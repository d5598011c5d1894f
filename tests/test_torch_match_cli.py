"""The port's whole no-ground-truth workflow through its CLI on the CPU:
raw PNG pairs -> prepare -> genconfig --stage matcher -> match ->
autocalibrate -> stereo, with no extrinsics given (the scenes and matcher
settings of tests/test_pipeline_e2e.py:70-121, through matcher_config.txt)."""

import numpy as np
import pytest
import torch

from wass_tpu_torch.cli.main import main
from wass_tpu_torch.io import png
from wass_tpu_torch.io.matrices import save_matrix_xml
from wass_tpu_torch.io.workdir import frame_workdirs
from wass_tpu_torch.io.xyzc import load_camera_mesh
from wass_tpu_torch.testing import make_scene
from wass_tpu_torch.testing.synthetic import make_rig
from torch_registries import reset_registries  # noqa: F401  (autouse)

W, H, N_FRAMES = 384, 288, 6
MATCH_FILES = ("ext_R.xml", "ext_T.xml", "matches.txt", "matches_epionly.txt", "matches_unfiltered.txt",
               "matcher_stats.csv", "wass_match_log.txt", "matches.jpg", "matches_epifilter.jpg")
MATCHER_OPTIONS = {"NUM_FEATURES_PER_IMAGE": 1200, "MATCHER_MAX_ROUNDS": 8, "FEATURE_HESSIAN_THRESHOLD": 3e-5,
                   "FEATURE_MIN_DISTANCE": 8}
STEREO_OPTIONS = {"MAX_DISPARITY": 64, "PLANE_RANSAC_THRESHOLD": 0.1, "PLANE_MAX_DISTANCE": 0.3}


def _set_options(path, options):
    lines = path.read_text().splitlines()
    for i, line in enumerate(lines):
        key = line.partition("=")[0]
        if key in options:
            lines[i] = f"{key}={options[key]}"
    path.write_text("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def workflow(tmp_path_factory):
    """Six raw frame pairs of a moving sea with intrinsics only, run
    through every command on the CPU (on two intra-op threads, restored
    after)."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp("raw")
    rig = make_rig(width=W, height=H)
    scenes = [make_scene(seed=100 + i, width=W, height=H, wave_amplitude=0.25, rig=rig, time=i * 0.2)
              for i in range(N_FRAMES)]
    for d in ("cam0", "cam1", "calib"):
        (root / d).mkdir()
    for i, sc in enumerate(scenes):
        for cam, img in enumerate((sc.img0, sc.img1)):
            png.write_gray(root / f"cam{cam}" / f"{i:06d}.png", np.clip(img, 0, 255).astype(np.uint8))
    save_matrix_xml(root / "calib" / "intrinsics_00.xml", "intrinsics", rig.K0)
    save_matrix_xml(root / "calib" / "intrinsics_01.xml", "intrinsics", rig.K1)
    seq = root / "seq"
    assert main(["prepare", str(root / "cam0"), str(root / "cam1"), str(root / "calib"), str(seq),
                 "--device", "cpu"]) == 0
    assert main(["genconfig", str(seq), "--stage", "matcher"]) == 0
    _set_options(seq / "matcher_config.txt", MATCHER_OPTIONS)
    assert main(["genconfig", str(seq), "--stage", "stereo"]) == 0
    _set_options(seq / "stereo_config.txt", STEREO_OPTIONS)
    assert not any(wd.has_extrinsics() for wd in frame_workdirs(seq))
    assert main(["match", str(seq), "--device", "cpu"]) == 0
    assert main(["autocalibrate", str(seq), "--device", "cpu"]) == 0
    assert main(["stereo", str(seq), "--device", "cpu"]) == 0
    torch.set_num_threads(n_threads)
    return seq, rig, scenes


def test_match_and_autocalibrate_outputs(workflow):
    """The files the JAX package's CLI writes; the pooled extrinsics
    broadcast to every workdir; the reference's pose gates."""
    seq, rig, _ = workflow
    wds = frame_workdirs(seq)
    assert len(wds) == N_FRAMES
    for wd in wds:
        for name in (*MATCH_FILES, "H.xml"):
            assert (wd.path / name).exists(), f"{wd.path.name}: {name} missing"
        n_matches = int((wd.path / "matcher_stats.csv").read_text().splitlines()[1].split(";")[0])
        assert n_matches >= 40
    log = (seq / "wass_autocalibrate_log.txt").read_text()
    assert "[INFO] pooled inliers:" in log and "[INFO] accepted (improved):" in log
    R, T = wds[0].load_extrinsics()
    for wd in wds[1:]:
        Ri, Ti = wd.load_extrinsics()
        np.testing.assert_array_equal(Ri, R)
        np.testing.assert_array_equal(Ti, T)
    Tg = rig.T / np.linalg.norm(rig.T)
    print(f"pooled pose: |dR| {np.abs(R - rig.R).max():.3g}, |dT| {np.abs(T.ravel() - Tg).max():.3g}")
    assert np.abs(R - rig.R).max() < 5e-3
    assert np.abs(T.ravel() - Tg).max() < 2e-2


def test_stereo_with_recovered_extrinsics(workflow):
    """Every frame reconstructed with the recovered extrinsics: a mesh over
    30% of the pixels, a finite plane, and a trimmed-mean elevation error
    under 0.08.  The JAX test's 0.04 at this resolution assumes a pooled
    rotation error near 1e-4; the pose recovered from 0.1 MP frames is
    ~1e-3 in R (printed above), which the mesh error follows."""
    seq, _, scenes = workflow
    errors = []
    for i, wd in enumerate(frame_workdirs(seq)):
        mesh = load_camera_mesh(wd.path / "mesh_cam.xyzC")
        assert mesh.shape[1] > 0.3 * W * H
        plane = wd.load_plane()
        assert np.isfinite(plane).all()
        err = scenes[i].elevation_error(mesh.T, plane)
        ae = np.sort(np.abs(err[np.isfinite(err)]))
        errors.append(ae[: int(len(ae) * 0.999)].mean())
    print("trimmed-mean elevation errors:", " ".join(f"{e:.4f}" for e in errors))
    assert max(errors) < 0.08
    assert (seq / "output" / "planes.txt").exists()
