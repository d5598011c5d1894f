"""The stereo CLI with ENABLE_OPTICAL_FLOW=true: the port's `stereo` (CPU,
plain versions) and the JAX package's SequencePipeline on one 256x192
frame, each writing flow_coarse.png, flow.png and mesh_full_flow.ply
beside the stereo outputs.

Both packages draw the same RANSAC pixel picks and run their float stages
op by op, as tests/test_torch_pipeline_lr.py.  Compared: the PLY header
form, the vertex counts (within 0.5%: the solvers sum their averages in
different orders, tests/test_torch_flow.py), the clouds' centroids
(within 1e-4 of the cloud's extent) and grey levels (their means within
0.1), and the decoded renders
(the coarse flow's within 1 grey level at all but a few pixels, the
refined flow's at all but 1% of them).  With the option off the port
writes none of the three files and the same stereo files."""

import shutil

import imageio.v3 as iio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wass_tpu.io.workdir import Workdir
from wass_tpu.stereo import dense as jd
from wass_tpu.testing import make_rig, make_scene
from wass_tpu_torch.cli.main import main as torch_main
from wass_tpu_torch.stereo import plane as tplane
from torch_registries import reset_registries  # noqa: F401  (autouse)

FLOW_FILES = ("flow_coarse.png", "flow.png", "mesh_full_flow.ply")


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_picks(rounds, H, W, seed):
    k1, _ = jax.random.split(jax.random.PRNGKey(seed))
    return torch.from_numpy(np.asarray(jax.random.randint(k1, (rounds, 3, 2), 0, jnp.array([W, H]))))


def _read_ply(path):
    data = path.read_bytes()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode()
    n = int(header.split("element vertex ")[1].split("\n")[0])
    rec = np.frombuffer(data[end:], dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)], count=n)
    return header.replace(f"element vertex {n}\n", "element vertex N\n"), rec


@pytest.fixture(scope="module")
def sequences(tmp_path_factory):
    root = tmp_path_factory.mktemp("flowseq")
    base = root / "base"
    rig = make_rig(width=256, height=192)
    sc = make_scene(seed=50, width=256, height=192, wave_amplitude=0.25, rig=rig)
    wd = Workdir(base / "000000_wd").create()
    wd.save_undistorted(0, sc.img0)
    wd.save_undistorted(1, sc.img1)
    wd.save_intrinsics(0, rig.K0)
    wd.save_intrinsics(1, rig.K1)
    wd.save_extrinsics(rig.R, rig.T)
    (base / "stereo_config.txt").write_text("MAX_DISPARITY=96\nENABLE_OPTICAL_FLOW=true\n"
                                            "FLOW_REFINEMENT_FULLRES_ITERATIONS=100\n")
    for name in ("jax", "torch", "torch_off"):
        shutil.copytree(base, root / name)
    (root / "torch_off" / "stereo_config.txt").write_text("MAX_DISPARITY=96\n")
    return root


def test_flow_sequence_matches_jax(sequences, monkeypatch):
    from wass_tpu.cli.main import _load_pipeline

    seq_j, seq_t = sequences / "jax", sequences / "torch"
    pipe = _load_pipeline(seq_j)
    assert pipe.cfg.flow is not None and pipe.cfg.flow.fullres_iterations == 100
    pipe.cfg.debug_renders = False
    monkeypatch.setattr(jax, "devices", lambda *a: jax.local_devices()[:1])  # the one-device loop
    monkeypatch.setattr(jd, "_jit_triangulate", jd._jit_triangulate.__wrapped__)
    monkeypatch.setattr(jd, "_stage_plane", jd._stage_plane.__wrapped__)
    pipe.stereo()

    monkeypatch.setattr(tplane, "draw_pixels", _jax_picks)
    assert torch_main(["stereo", str(seq_t), "--device", "cpu"]) == 0
    assert torch_main(["stereo", str(sequences / "torch_off"), "--device", "cpu"]) == 0

    wj, wt, woff = (s / "000000_wd" for s in (seq_j, seq_t, sequences / "torch_off"))
    for name in FLOW_FILES:
        assert (wj / name).exists() and (wt / name).exists() and not (woff / name).exists()
    for name in ("mesh_cam.xyzC", "plane.txt"):  # the flow does not touch the stereo outputs
        assert (wt / name).read_bytes() == (woff / name).read_bytes()
    log = (wt / "wass_stereo_log.txt").read_text()
    assert "flow_jacobi=0 flow_linearize=0" in log  # the CPU runs the plain versions
    assert "flow_" not in (woff / "wass_stereo_log.txt").read_text()

    hj, rj = _read_ply(wj / "mesh_full_flow.ply")
    ht, rt = _read_ply(wt / "mesh_full_flow.ply")
    assert ht == hj
    assert len(rj) > 5000 and abs(len(rt) - len(rj)) <= 0.005 * len(rj)
    assert np.isfinite(rt["xyz"]).all()
    extent = np.ptp(rj["xyz"], axis=0).max()
    assert np.abs(rt["xyz"].mean(0) - rj["xyz"].mean(0)).max() <= 1e-4 * extent
    assert (rt["rgb"][:, 0] == rt["rgb"][:, 2]).all()
    assert abs(rt["rgb"].mean() - rj["rgb"].mean()) <= 0.1

    for name, share in (("flow_coarse.png", 1e-4), ("flow.png", 1e-2)):
        a, b = iio.imread(wj / name), iio.imread(wt / name)
        assert a.shape == b.shape == (192, 256, 3)
        assert np.mean(np.abs(a.astype(int) - b.astype(int)).max(-1) > 1) <= share, name
