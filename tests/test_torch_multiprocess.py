"""Two processes of the port under a torch.distributed gloo group (CPU;
jax and the JAX package refused in them) drive the stereo loop over 8
frame slots (4 a rank) and over 4 (2 a rank), and the distributed BA; the
test process holds their results against the JAX package's sharded runner
and sharded BA on its 8 virtual devices and against a single-process port
run (tests/test_multiprocess.py on the port).  Not marked slow: the
workers take ~20 s."""

import io
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import torch

from wass_tpu.parallel import runner as jrun
from wass_tpu.parallel.distba import lm_refine_two_view_sharded as jax_sharded_ba
from wass_tpu.parallel.mesh import make_frame_mesh as jax_mesh
from wass_tpu.stereo import dense as jd
from wass_tpu.testing import make_scene

ROOT = Path(__file__).resolve().parents[1]
H, W, F, N_SEQ = 64, 96, 8, 5
CFG = dict(num_disp=16, min_disp=1, plane_ransac_rounds=64, plane_ransac_threshold=0.1, plane_max_distance=0.3)
# Part 1's: the smoothing the JAX runner takes for an unresolved AUTO.
FRAMES_CFG = dict(CFG, input_smooth_sigma=0.8)

_WORKER = textwrap.dedent(
    """
    import importlib.abc, io, sys
    from pathlib import Path

    class _Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "wass_tpu"):
                raise ImportError(f"{name} is refused in this process")
            return None

    sys.meta_path.insert(0, _Refuse())
    import numpy as np
    import torch

    torch.set_num_threads(1)
    pid, port, shared = int(sys.argv[1]), sys.argv[2], Path(sys.argv[3])
    from wass_tpu_torch import instrument
    from wass_tpu_torch.cli.pipeline import SequenceConfig, SequencePipeline
    from wass_tpu_torch.parallel.distba import lm_refine_two_view_sharded
    from wass_tpu_torch.parallel.mesh import local_frame_indices, make_frame_mesh
    from wass_tpu_torch.parallel.runner import initialize_multihost
    from wass_tpu_torch.stereo.dense import DenseStereoConfig, DenseStereoPipeline

    assert initialize_multihost(f"localhost:{port}", 2, pid, backend="gloo")
    cfg = DenseStereoConfig(**%r)
    inp = np.load(shared / "inputs.npz")
    out = {}

    # 1. stereo() over 8 frames of one pair, 8 slots, 4 a rank: each rank
    # runs its own slots' frames, with the JAX runner's RANSAC picks, and
    # keeps their disparities as the slots computed them
    mesh = make_frame_mesh(devices=["cpu"] * 4)
    slots = local_frame_indices(mesh)
    assert len(mesh) == 8 and slots == [4 * pid + i for i in range(4)], slots
    picks, disparity = torch.from_numpy(inp["uv"]), {}
    call = DenseStereoPipeline.__call__

    def keep(self, base_rect, match_rect, geom_pack, uv=None):
        res = call(self, base_rect, match_rect, geom_pack, uv=picks if uv is None else uv)
        disparity[instrument.current().index] = res.disparity.numpy()
        return res

    DenseStereoPipeline.__call__ = keep
    pipe = SequencePipeline(shared / "frames", SequenceConfig(stereo=DenseStereoConfig(**%r), device="cpu",
                                                              debug_renders=False))
    pipe._frame_mesh = lambda: make_frame_mesh(devices=["cpu"] * 4)
    planes = pipe.stereo(progress_stream=io.StringIO())
    DenseStereoPipeline.__call__ = call
    assert sorted(disparity) == slots, sorted(disparity)
    out["disparity"] = np.stack([disparity[i] for i in slots])
    out["planes"] = np.stack(planes)
    print(f"[{pid}] frames ok", flush=True)

    # 2. stereo(): 2 slots a rank over the shared sequence, each rank writing
    # its own frames, rank 0 planes.txt
    pipe = SequencePipeline(shared / "seq", SequenceConfig(stereo=cfg, device="cpu", debug_renders=False))
    pipe._frame_mesh = lambda: make_frame_mesh(devices=["cpu"] * 2)
    planes = pipe.stereo(progress_stream=io.StringIO())
    out["seq_planes"] = np.stack(planes)
    print(f"[{pid}] pipeline ok", flush=True)

    # 3. the distributed Schur BA: each rank passes the rows of its slots
    rows = len(inp["mask"]) // 2
    lo, hi = pid * rows, (pid + 1) * rows
    ba = lm_refine_two_view_sharded(mesh, inp["Rp"], inp["Tp"], inp["Xp"][lo:hi], inp["p0"][lo:hi],
                                    inp["p1"][lo:hi], inp["mask"][lo:hi], max_iters=40)
    out["R"], out["T"] = ba.R.numpy(), ba.T.numpy()
    np.savez(shared / f"out{pid}.npz", **out)
    print(f"[{pid}] ALL-OK", flush=True)
    """ % (CFG, FRAMES_CFG)
)


def _ba_problem(rng, n=512):
    """tests/test_multiprocess.py's BA problem."""
    R, _ = cv2.Rodrigues(np.array([0.02, -0.25, 0.015]))
    T = np.array([-1.0, 0.02, 0.06])
    T /= np.linalg.norm(T)
    pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-4, 4, n), rng.uniform(8, 25, n)], 1)
    p0 = pts[:, :2] / pts[:, 2:] + rng.standard_normal((n, 2)) * 2e-4
    x1 = pts @ R.T + T
    p1 = x1[:, :2] / x1[:, 2:] + rng.standard_normal((n, 2)) * 2e-4
    Rp, _ = cv2.Rodrigues(cv2.Rodrigues(R)[0].ravel() + np.array([2e-3, -1.5e-3, 1e-3]))
    Tp = T + np.array([3e-3, -2e-3, 1e-3])
    Xp = pts + rng.standard_normal(pts.shape) * 0.05
    mask = np.ones(n, bool)
    mask[500:] = False
    return [np.asarray(a, np.float32) for a in (Rp, Tp, Xp, p0, p1)] + [mask]


def _write_seq(root):
    from wass_tpu_torch.testing import write_pairs

    rig = make_scene(seed=3, width=W, height=H, wave_amplitude=0.25).rig
    scenes = [make_scene(seed=300 + i, width=W, height=H, wave_amplitude=0.25, rig=rig, time=i * 0.25)
              for i in range(N_SEQ)]
    write_pairs(root, [(s.img0, s.img1) for s in scenes], rig)


def _seq_files(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(Path(root).rglob("*"))
            if p.name in ("mesh_cam.xyzC", "plane.txt", "planes.txt", "workspaces.txt")}


def test_two_process_runner_pipeline_distba(tmp_path):
    from wass_tpu_torch import convert
    from wass_tpu_torch.cli.pipeline import SequenceConfig, SequencePipeline

    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        from wass_tpu_torch.io.png import read_gray
        from wass_tpu_torch.io.workdir import Workdir
        from wass_tpu_torch.testing import write_pairs

        sc = make_scene(seed=3, width=W, height=H, wave_amplitude=0.25)
        rig = sc.rig
        jcfg = jd.DenseStereoConfig(**CFG)
        geom = jd.prepare_frame_geometry(rig.K0, rig.K1, rig.R, rig.T, (W, H))
        gp = jd.build_geom_pack(geom, (H, W))
        # Part 1's frames: the pair 8 times; the JAX runner reads its 8-bit PNGs.
        write_pairs(tmp_path / "frames", [(sc.img0, sc.img1)] * F, rig)
        img0, img1 = (read_gray(Workdir(tmp_path / "frames" / "000000_wd").undistorted_path(c)) for c in (0, 1))
        b_img, m_img = (img0, img1) if geom.base_is_cam0 else (img1, img0)
        stack = lambda x: np.broadcast_to(np.asarray(x, np.float32), (F, H, W)).copy()
        k1, _ = jax.random.split(jax.random.PRNGKey(0))
        uv = np.array(jax.random.randint(k1, (CFG["plane_ransac_rounds"], 3, 2), 0, jnp.array([W, H])))
        Rp, Tp, Xp, p0, p1, mask = _ba_problem(np.random.default_rng(42))
        _write_seq(tmp_path / "seq")
        _write_seq(tmp_path / "ref")
        np.savez(tmp_path / "inputs.npz", uv=uv, Rp=Rp, Tp=Tp, Xp=Xp, p0=p0, p1=p1, mask=mask)

        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        script = tmp_path / "worker.py"
        script.write_text(_WORKER)
        env = {**os.environ, "PYTHONPATH": str(ROOT)}
        env.pop("JAX_PLATFORMS", None)
        procs = [subprocess.Popen([sys.executable, str(script), str(i), str(port), str(tmp_path)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
                 for i in range(2)]
        try:
            # The references, while the workers run.
            jres = jrun.ShardedDenseRunner(jax_mesh(F), jd.DenseStereoConfig(**FRAMES_CFG)).run_batch(
                stack(b_img), stack(m_img), [gp] * F)[0]
            jba = jax_sharded_ba(jax_mesh(F), *(jnp.asarray(a) for a in (Rp, Tp, Xp, p0, p1)), jnp.asarray(mask),
                                 max_iters=40)
            ref_planes = SequencePipeline(tmp_path / "ref", SequenceConfig(
                stereo=convert.config_from_jax(jcfg), device="cpu", debug_renders=False)).stereo(
                progress_stream=io.StringIO())
            outs = [p.communicate(timeout=240)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for i, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0 and f"[{i}] ALL-OK" in out, f"process {i} failed:\n{out[-4000:]}"
    finally:
        torch.set_num_threads(torch_threads)

    res = [np.load(tmp_path / f"out{i}.npz") for i in range(2)]
    # Part 1: every rank's frames bit-equal to the JAX runner's, and every
    # frame's plane, gathered on both ranks, within 1e-4 of it.
    disp = np.concatenate([r["disparity"] for r in res])
    np.testing.assert_array_equal(disp, np.asarray(jres.disparity))
    for r in res:
        np.testing.assert_allclose(r["planes"], np.asarray(jres.plane), rtol=0, atol=1e-4)
    # stereo(): the two ranks' files are the single-process run's, byte for
    # byte, and both ranks hold every plane.
    assert _seq_files(tmp_path / "seq").keys() == _seq_files(tmp_path / "ref").keys()
    for (name, a), b in zip(_seq_files(tmp_path / "seq").items(), _seq_files(tmp_path / "ref").values()):
        if name != "workspaces.txt":  # the workdir paths differ
            assert a == b, name
    for r in res:
        np.testing.assert_array_equal(r["seq_planes"], np.stack(ref_planes))
    # The BA across the process boundary: R within 1e-5, T within 1e-4 of
    # the JAX package's sharded BA; both ranks agree bit for bit.
    assert np.array_equal(res[0]["R"], res[1]["R"]) and np.array_equal(res[0]["T"], res[1]["T"])
    np.testing.assert_allclose(res[0]["R"], np.asarray(jba.R), rtol=0, atol=1e-5)
    np.testing.assert_allclose(res[0]["T"], np.asarray(jba.T), rtol=0, atol=1e-4)
