"""Port parity of the frame-sharded path (wass_tpu_torch/parallel/ and the
stereo loop's slots) on the CPU: frame meshes of n slots on the one CPU
device, what each slot runs on a frame (DenseStereoPipeline with the
deferred c2f fallback, resolved as the writers resolve it) against the JAX
package's runner, and the sharded BA against its distributed BA, on its 8
virtual CPU devices (tests/test_parallel.py on the port); stereo() on
several slots against one slot; and the launch helper every kernel wrapper
goes through.

The JAX runner's c2f branch asks for a TPU; the c2f case patches its gate
to the shape gate and runs its windowed Pallas kernels in interpret mode
(the coarse pass's fused kernel through its lax.scan equivalent, which
the JAX package holds bit-equal to it), as tests/test_torch_c2f_pipeline.py
does.  The JAX package's files are untouched."""

import ast
import dataclasses
import io
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wass_tpu.parallel import runner as jrun
from wass_tpu.parallel.distba import lm_refine_two_view_sharded as jax_sharded_ba
from wass_tpu.parallel.mesh import make_frame_mesh as jax_mesh
from wass_tpu.stereo import dense as jd
from wass_tpu.stereo import sgm as jsgm
from wass_tpu.stereo import sgm_pallas
from wass_tpu.stereo.c2f import c2f_supported
from wass_tpu.testing import make_scene
from wass_tpu_torch import _build, convert
from wass_tpu_torch.calib import ba as tba
from wass_tpu_torch.parallel import distba, mesh as tmesh
from wass_tpu_torch.stereo import dense as td

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: the plain versions are
    thousands of small ops, and the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(**kw):
    """tests/test_parallel.py's configuration."""
    return jd.DenseStereoConfig(num_disp=16, min_disp=1, plane_ransac_rounds=64, plane_ransac_threshold=0.1,
                                plane_max_distance=0.3, **kw)


def _picks(cfg, h, w):
    """The RANSAC pixel picks the JAX plane stage draws (plane.py:47-48)."""
    k1, _ = jax.random.split(jax.random.PRNGKey(cfg.random_seed))
    return torch.from_numpy(np.array(jax.random.randint(k1, (cfg.plane_ransac_rounds, 3, 2), 0, jnp.array([w, h]))))


def _batch(scenes, geom):
    bs = np.stack([np.asarray(s.img0 if geom.base_is_cam0 else s.img1, np.float32) for s in scenes])
    ms = np.stack([np.asarray(s.img1 if geom.base_is_cam0 else s.img0, np.float32) for s in scenes])
    return bs, ms


def _port_pack(gp):
    return convert.geom_pack_from_numpy({k: np.asarray(v) for k, v in gp.items()})


@pytest.fixture(scope="module")
def frames8():
    """tests/test_parallel.py's 8-frame batch (one 64x96 pair) through the
    JAX runner on its 8 virtual devices."""
    h, w, F = 64, 96, 8
    sc = make_scene(seed=3, width=w, height=h, wave_amplitude=0.25)
    rig = sc.rig
    cfg = _jcfg()
    geom = jd.prepare_frame_geometry(rig.K0, rig.K1, rig.R, rig.T, (w, h))
    gp = jd.build_geom_pack(geom, (h, w))
    bs, ms = _batch([sc] * F, geom)
    jres = jrun.ShardedDenseRunner(jax_mesh(F), cfg).run_batch(bs, ms, [gp] * F)
    return dict(cfg=cfg, bs=bs, ms=ms, gp=gp, tgp=_port_pack(gp), uv=_picks(cfg, h, w), jax=jres, F=F)


def _slot_frames(bs, ms, tgp, cfg, uv):
    """Each frame as a slot of the stereo loop runs it: rectified, through
    a DenseStereoPipeline with the deferred c2f fallback, the fallback then
    resolved as the writers resolve it.  Returns (results, resolved c2f
    dicts, None where c2f did not run)."""
    cfg = convert.config_from_jax(cfg)
    results, c2f = [], []
    for bi, mi in zip(bs, ms):
        pipe = td.DenseStereoPipeline(cfg, defer_c2f_fallback=True)
        shape = tuple(bi.shape)
        br = td.rectify_on_device(torch.from_numpy(bi), tgp["H_base"], shape)
        mr = td.rectify_on_device(torch.from_numpy(mi), tgp["H_match"], shape)
        res = pipe(br, mr, tgp, uv=uv)
        res, info = pipe.resolve_fallback(res, pipe.last_c2f, br, mr, tgp, uv=uv)
        results.append(res)
        c2f.append(info)
    return results, c2f


def _assert_frames_match_jax(res, c2f, jres):
    """Disparity bit-equal per frame; planes within 1e-4
    (tests/test_torch_dense.py's whole-frame tolerance), n_points within
    0.1%; the same frames fall back to full range."""
    rj, _rects, infoj, _mean = jres
    for k, r in enumerate(res):
        np.testing.assert_array_equal(r.disparity.numpy(), np.asarray(rj.disparity)[k])
        assert bool(r.plane_ok) and bool(np.asarray(rj.plane_ok)[k])
        np.testing.assert_allclose(r.plane.numpy(), np.asarray(rj.plane)[k], rtol=0, atol=1e-4)
        nj = int(np.asarray(rj.n_points)[k])
        assert abs(int(r.n_points) - nj) <= 0.001 * nj
    assert [k for k, c in enumerate(c2f) if c is not None and c["fallback"]] == infoj["fallback_frames"]


# --- meshes --------------------------------------------------------------------


def test_frame_mesh_slots():
    """n CPU slots stand in for the JAX package's n virtual devices; one
    process owns them all."""
    mesh = tmesh.make_frame_mesh(devices=["cpu"] * 8)
    assert len(mesh) == 8 and all(s == tmesh.Slot(0, torch.device("cpu")) for s in mesh)
    assert tmesh.local_frame_indices(mesh) == list(range(8))
    assert tmesh.local_frame_indices(mesh) == jrun.local_frame_indices(jax_mesh(8))
    two = tmesh.make_frame_mesh(2, devices=["cpu", "cpu"])
    assert [s.device.type for s in two] == ["cpu", "cpu"]
    with pytest.raises(ValueError, match="at least one device"):
        tmesh.make_frame_mesh(devices=[])
    if not torch.cuda.is_available():  # the default devices are cards: no CPU fallback
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            tmesh.make_frame_mesh()


def test_initialize_multihost_without_coordinator_is_a_noop():
    from wass_tpu_torch.parallel.runner import initialize_multihost

    assert initialize_multihost() is False and not tmesh.group_active()
    t = torch.arange(3.0)
    assert tmesh.all_reduce_sum(t) is t and tmesh.all_gather_host(5) == [5]


# --- a slot's frame ---------------------------------------------------------------


def test_sharded_runner_matches_jax(frames8):
    """8 frames, each as a slot runs it, against the JAX package's sharded runner
    on 8 virtual devices: disparities bit-equal, planes within 1e-4; c2f
    does not run at this size."""
    f = frames8
    res, c2f = _slot_frames(f["bs"], f["ms"], f["tgp"], f["cfg"], f["uv"])
    assert len(res) == f["F"] and c2f == [None] * f["F"]
    assert f["jax"][2]["coverage"] is None
    _assert_frames_match_jax(res, c2f, f["jax"])


def _jax_c2f_on_cpu(monkeypatch):
    """The JAX runner's c2f branch on the CPU: the shape gate alone, the
    windowed Pallas kernels in interpret mode, the coarse fused kernel as
    its lax.scan equivalent."""
    def active(cfg, shape):
        h, w = shape
        return cfg.c2f_window > 0 and c2f_supported(h, w, cfg.num_disp, cfg.c2f_window, cfg.c2f_factor,
                                                    cfg.directions, cfg.lr_max_diff)

    cost_w, agg_w = sgm_pallas.census_cost_volume_pallas_windowed, sgm_pallas.sgm_aggregate_pallas_windowed
    monkeypatch.setattr(jrun, "_c2f_active", active)
    monkeypatch.setattr(sgm_pallas, "census_cost_volume_pallas_windowed", lambda *a, **k: cost_w(*a, interpret=True))
    monkeypatch.setattr(sgm_pallas, "sgm_aggregate_pallas_windowed", lambda *a, **k: agg_w(*a, interpret=True))
    monkeypatch.setattr(sgm_pallas, "sgm_wta_fused_pallas",
                        lambda cost, P1, P2, d, md, u=1: jsgm.wta_disparity(jsgm.sgm_aggregate(cost, P1, P2, d), md, u))


C2F_CFG = dict(num_disp=32, min_disp=1, c2f_window=16, c2f_factor=4, input_smooth_sigma=0.0, plane_ransac_rounds=64,
               plane_ransac_threshold=0.1, plane_max_distance=0.3)


def test_sharded_runner_c2f_matches_jax(monkeypatch):
    """A c2f-sized batch (64x128, num_disp 32, window 16, two frames): one
    frame's coarse windows miss (its off-band share trips the guard) and
    the writers' resolution re-runs it at full range; the other keeps the
    windowed pass (K2 + K4 here, K2 + K6 + the windowed WTA in the JAX
    runner); both packages take the same branches, with the same coverage
    and off-band scalars, and give the same disparities."""
    _jax_c2f_on_cpu(monkeypatch)
    h, w, F = 64, 128, 2
    scenes = [make_scene(seed=3 + i, width=w, height=h, wave_amplitude=0.25) for i in range(F)]
    rig = scenes[0].rig
    cfg = jd.DenseStereoConfig(**C2F_CFG)
    geom = jd.prepare_frame_geometry(rig.K0, rig.K1, rig.R, rig.T, (w, h))
    gp = jd.build_geom_pack(geom, (h, w))
    bs, ms = _batch(scenes, geom)
    jres = jrun.ShardedDenseRunner(jax_mesh(F), cfg).run_batch(bs, ms, [gp] * F)
    res, c2f = _slot_frames(bs, ms, _port_pack(gp), cfg, _picks(cfg, h, w))
    infoj = jres[2]
    np.testing.assert_allclose([c["coverage"] for c in c2f], infoj["coverage"], rtol=0, atol=1e-6)
    np.testing.assert_allclose([c["offband"] for c in c2f], infoj["offband"], rtol=0, atol=1e-6)
    assert [c["fallback"] for c in c2f] == [True, False] and infoj["fallback_frames"] == [0]
    _assert_frames_match_jax(res, c2f, jres)


# --- the sharded BA ------------------------------------------------------------


def _ba_problem(rng, n=512):
    """tests/test_parallel.py:_ba_problem."""
    R, _ = cv2.Rodrigues(np.array([0.02, -0.25, 0.015]))
    T = np.array([-1.0, 0.02, 0.06])
    T /= np.linalg.norm(T)
    pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-4, 4, n), rng.uniform(8, 25, n)], 1)
    p0 = pts[:, :2] / pts[:, 2:]
    x1 = pts @ R.T + T
    p1 = x1[:, :2] / x1[:, 2:]
    p0 = p0 + rng.standard_normal(p0.shape) * 2e-4
    p1 = p1 + rng.standard_normal(p1.shape) * 2e-4
    Rp, _ = cv2.Rodrigues(cv2.Rodrigues(R)[0].ravel() + np.array([2e-3, -1.5e-3, 1e-3]))
    Tp = T + np.array([3e-3, -2e-3, 1e-3])
    Xp = pts + rng.standard_normal(pts.shape) * 0.05
    return R, T, Rp, Tp, Xp, p0, p1


@pytest.mark.parametrize("n_slots", [8, 3])
def test_sharded_ba_matches_jax(rng, n_slots):
    """The point-sharded LM on n CPU slots (8: the JAX mesh's split; 3: a
    padded split) against JAX's lm_refine_two_view_sharded on 8 virtual
    devices: R within 1e-5, T within 1e-4 (tests/test_torch_calib.py's
    float32 tolerances).  Against the port's unsharded LM: R and T's
    direction within 5e-5, |T| within 1e-4.  |T| is the gauge of two-view
    BA (the points and T scale together), set by the damping's path, and
    in float32 the shards' sums in another order stop the loop at another
    step (22 steps against 24 on 8 slots; |T| 6.8e-5 apart); in float64
    the two agree to 1e-10 (test_sharded_ba_float64).  The ground truth is
    recovered."""
    R, T, Rp, Tp, Xp, p0, p1 = _ba_problem(rng)
    mask = np.ones(len(Xp), bool)
    mask[500:] = False
    a32 = [np.asarray(a, np.float32) for a in (Rp, Tp, Xp, p0, p1)]
    rj = jax_sharded_ba(jax_mesh(8), *(jnp.asarray(a) for a in a32), jnp.asarray(mask), max_iters=40)
    single = tba.lm_refine_two_view(*(torch.from_numpy(a) for a in a32), torch.from_numpy(mask), max_iters=40)
    (Xs, q0, q1), m = distba.pad_points_for_mesh(a32[2:], mask, n_slots)
    rt = distba.lm_refine_two_view_sharded(tmesh.make_frame_mesh(devices=["cpu"] * n_slots), a32[0], a32[1], Xs, q0,
                                           q1, m, max_iters=40)
    print(f"{n_slots} slots: LM steps port {rt.n_iters}, unsharded {single.n_iters}, JAX sharded {int(rj.n_iters)}")
    assert rt.X.shape == (len(m), 3) and rt.n_iters < 40
    Tt, Ts = rt.T.numpy(), single.T.numpy()
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), rtol=0, atol=1e-5)
    np.testing.assert_allclose(Tt, np.asarray(rj.T), rtol=0, atol=1e-4)
    np.testing.assert_allclose(rt.R.numpy(), single.R.numpy(), rtol=0, atol=5e-5)
    np.testing.assert_allclose(Tt / np.linalg.norm(Tt), Ts / np.linalg.norm(Ts), rtol=0, atol=5e-5)
    np.testing.assert_allclose(Tt, Ts, rtol=0, atol=1e-4)
    Tr = Tt / np.linalg.norm(Tt)
    assert np.abs(rt.R.numpy() - R).max() < 1e-3 and np.abs(Tr - T).max() < 5e-3


@pytest.mark.parametrize("n_slots", [8, 3])
def test_sharded_ba_float64(rng, n_slots):
    """In float64 the sharded and unsharded LM take the same steps and agree
    to 1e-10 in R and T (the sums differ in order only)."""
    _R, _T, Rp, Tp, Xp, p0, p1 = _ba_problem(rng)
    mask = np.ones(len(Xp), bool)
    mask[500:] = False
    single = tba.lm_refine_two_view(*(torch.from_numpy(np.asarray(a, np.float64)) for a in (Rp, Tp, Xp, p0, p1)),
                                    torch.from_numpy(mask), max_iters=40)
    (Xs, q0, q1), m = distba.pad_points_for_mesh([Xp, p0, p1], mask, n_slots)
    rt = distba.lm_refine_two_view_sharded(tmesh.make_frame_mesh(devices=["cpu"] * n_slots), Rp, Tp, Xs, q0, q1, m,
                                           max_iters=40)
    assert rt.R.dtype == torch.float64 and rt.n_iters == single.n_iters
    np.testing.assert_allclose(rt.R.numpy(), single.R.numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(rt.T.numpy(), single.T.numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(rt.X.numpy()[:500], single.X.numpy()[:500], rtol=0, atol=1e-8)


def test_one_shard_is_the_unsharded_ba(rng):
    """A single shard takes exactly the unsharded steps (the reduction
    over one shard is the identity)."""
    _R, _T, Rp, Tp, Xp, p0, p1 = _ba_problem(rng, n=128)
    a = [torch.from_numpy(np.asarray(x, np.float32)) for x in (Rp, Tp, Xp, p0, p1)]
    mask = torch.ones(128, dtype=torch.bool)
    one = tba.lm_refine_two_view(*a, mask, max_iters=20)
    shard = tba.lm_refine_two_view(a[0], a[1], [a[2]], [a[3]], [a[4]], [mask], max_iters=20)
    assert one.n_iters == shard.n_iters
    for x, y in ((one.R, shard.R), (one.T, shard.T), (one.X, shard.X[0]), (one.final_cost, shard.final_cost)):
        assert torch.equal(x, y)


def test_pad_points_for_mesh():
    arrs = [np.ones((13, 3)), np.ones((13, 2))]
    (a, b), m = distba.pad_points_for_mesh(arrs, np.ones(13, bool), 8)
    assert a.shape[0] == 16 and b.shape[0] == 16 and m.sum() == 13
    with pytest.raises(ValueError, match="pad them"):
        distba.lm_refine_two_view_sharded(tmesh.make_frame_mesh(devices=["cpu"] * 8), np.eye(3), np.ones(3),
                                          arrs[0], arrs[1][:, :2], arrs[1][:, :2], np.ones(13, bool))


# --- stereo() on several slots ---------------------------------------------------


def _write_seq(root, n, h=64, w=96, amplitude=0.25):
    from wass_tpu_torch.testing import write_pairs

    rig = make_scene(seed=3, width=w, height=h, wave_amplitude=amplitude).rig
    scenes = [make_scene(seed=300 + i, width=w, height=h, wave_amplitude=amplitude, rig=rig, time=i * 0.25)
              for i in range(n)]
    write_pairs(root, [(s.img0, s.img1) for s in scenes], rig)


FILES = ("mesh_cam.xyzC", "plane.txt", "planes.txt", "P0cam.txt", "P1cam.txt")


def _stereo_files(root, n_slots=None, stereo=None):
    """stereo() on the CPU: the pipeline's own frame mesh, or one of n_slots
    slots on the one CPU device.  stereo: the DenseStereoConfig (the
    tests/test_parallel.py one by default)."""
    from wass_tpu_torch.cli.pipeline import SequenceConfig, SequencePipeline

    cfg = SequenceConfig(stereo=stereo or convert.config_from_jax(_jcfg()), device="cpu")
    pipe = SequencePipeline(root, cfg)
    if n_slots is not None:
        pipe._frame_mesh = lambda: tmesh.make_frame_mesh(devices=["cpu"] * n_slots)
    out = io.StringIO()
    planes = pipe.stereo(progress_stream=out)
    files = {str(p.relative_to(root)): p.read_bytes() for p in sorted(Path(root).rglob("*")) if p.name in FILES}
    return planes, files, out.getvalue(), pipe


def _logs(root):
    """Each frame's wass_stereo_log.txt without its finalize wall time line."""
    return [[ln for ln in (wd / "wass_stereo_log.txt").read_text().splitlines() if "finalize wall time" not in ln]
            for wd in sorted(Path(root).glob("*_wd"))]


class _PoolSpy:
    """pipeline.ThreadPoolExecutor, keeping each pool's thread_name_prefix."""

    def __init__(self, prefixes):
        from wass_tpu_torch.cli import pipeline as pipeline_mod

        self.prefixes, self.real = prefixes, pipeline_mod.ThreadPoolExecutor

    def __call__(self, *a, **k):
        self.prefixes.append(k.get("thread_name_prefix"))
        return self.real(*a, **k)


def test_stereo_sharded_loop_equals_pipelined(tmp_path, monkeypatch):
    """5 frames over 3 CPU slots, each slot on a thread of its own: the
    files (mesh_cam.xyzC, plane.txt, P0/P1cam.txt, output/planes.txt) are
    byte-equal to one slot's, and so is every frame's log but its wall
    time line; every frame has its renders, a progress line follows each
    frame, and loop_stats holds one entry a frame."""
    from wass_tpu_torch.cli import pipeline as pipeline_mod

    for name in ("piped", "sharded"):
        _write_seq(tmp_path / name, 5)
    planes_p, files_p, _, _ = _stereo_files(tmp_path / "piped")
    pools: list = []
    monkeypatch.setattr(pipeline_mod, "ThreadPoolExecutor", _PoolSpy(pools))
    planes_s, files_s, progress, pipe = _stereo_files(tmp_path / "sharded", n_slots=3)
    assert pools.count("frame-slot") == 1
    assert len(files_s) == 5 * 4 + 1 and files_s == files_p
    np.testing.assert_array_equal(np.stack(planes_s), np.stack(planes_p))
    assert sorted(progress.split()) == sorted(f"[P|{i}|5]" for i in range(1, 6))
    assert len(pipe.loop_stats["dispatch_s"]) == len(pipe.loop_stats["loop.dispatch"]) == 5
    logs = _logs(tmp_path / "sharded")
    assert logs == _logs(tmp_path / "piped")
    for wd, log in zip(sorted((tmp_path / "sharded").glob("*_wd")), logs):
        assert log[0].startswith("[INFO] kernel launches:") and "triangulated+filtered points" in "".join(log)
        assert len(list(wd.glob("*.jpg"))) == 6


def test_one_slot_takes_the_pipelined_loop(tmp_path, monkeypatch):
    """One slot: the calling thread dispatches, and no slot thread starts."""
    from wass_tpu_torch.cli import pipeline as pipeline_mod

    _write_seq(tmp_path / "one", 2)
    pools: list = []
    monkeypatch.setattr(pipeline_mod, "ThreadPoolExecutor", _PoolSpy(pools))
    _stereo_files(tmp_path / "one")
    assert pools == ["stereo-writer"]


def test_only_tripped_frames_rerun(tmp_path, monkeypatch):
    """TestFallbackGranularity on the port: 3 frames of a c2f-active size
    (64x128, a calm sea: frames 0 and 2 windowed, frame 1 tripped) on 3
    slots, frame 2's fallback forced in the writers: that frame's files
    equal a c2f_window = 0 run's, and the other frames' those of a run
    without the forced trip."""
    from wass_tpu_torch import instrument
    from wass_tpu_torch.cli import pipeline as pipeline_mod

    stereo = convert.config_from_jax(jd.DenseStereoConfig(**C2F_CFG))
    for name in ("forced", "plain", "full"):
        _write_seq(tmp_path / name, 3, h=64, w=128, amplitude=0.1)
    _, plain, _, _ = _stereo_files(tmp_path / "plain", stereo=stereo)
    _, full, _, _ = _stereo_files(tmp_path / "full", stereo=dataclasses.replace(stereo, c2f_window=0))
    decide = td.c2f_should_fallback

    def forced(cov, offb, cfg):
        return instrument.current().index == 2 or decide(cov, offb, cfg)

    # The writer's decision (its writer.rerun span) and resolve_fallback's.
    monkeypatch.setattr(pipeline_mod, "c2f_should_fallback", forced)
    monkeypatch.setattr(td, "c2f_should_fallback", forced)
    _, files, _, _ = _stereo_files(tmp_path / "forced", n_slots=3, stereo=stereo)
    tail = lambda root: [log[1].rsplit(" ", 1)[-1] for log in _logs(root)]  # noqa: E731
    assert tail(tmp_path / "plain") == ["windowed", "SGM", "windowed"]
    assert tail(tmp_path / "forced") == ["windowed", "SGM", "SGM"]
    assert files["000002_wd/mesh_cam.xyzC"] != plain["000002_wd/mesh_cam.xyzC"]
    for name, data in files.items():
        if name.startswith("000002_wd/"):
            assert data == full[name], name
        elif name != "output/planes.txt":
            assert data == plain[name], name


# --- launches on the tensors' card -------------------------------------------------


def _launch_calls(path: Path):
    """Names of the C entry points `path` calls through _build.launch, and
    any call of a `wass_*` attribute outside it."""
    tree = ast.parse(path.read_text())
    launched, direct = [], []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr == "launch" and getattr(fn.value, "id", None) == "_build":
            launched.append(node.args[0].value)
        elif isinstance(fn, ast.Attribute) and fn.attr.startswith("wass_"):
            direct.append(fn.attr)
    return launched, direct


def test_every_wrapper_launches_through_the_device_guard():
    """Every C entry point that takes a stream is called through
    _build.launch and nowhere else (the lane-width query touches no
    device)."""
    launched, direct = [], []
    for path in sorted((ROOT / "wass_tpu_torch").rglob("*.py")):
        if path.name == "_build.py":
            continue
        a, b = _launch_calls(path)
        launched += a
        direct += b
    assert set(direct) <= {"wass_sgm_lane_width"}, direct
    entries = {name for name in _build._SIGNATURES if name != "wass_sgm_lane_width"}
    assert set(launched) == entries
    assert not hasattr(_build, "stream_handle")


def test_launch_sets_the_tensors_device(monkeypatch):
    """_build.launch calls the entry point with the device's stream while
    that device is the current one, and raises on an error code unless
    it is accepted."""
    state = {"current": "cuda:0"}
    seen = []

    class FakeDevice:
        def __init__(self, device):
            self.device = str(device)

        def __enter__(self):
            self.prev, state["current"] = state["current"], self.device

        def __exit__(self, *exc):
            state["current"] = self.prev

    class FakeStream:
        def __init__(self, device):
            self.cuda_stream = 7000 + torch.device(device).index

    class FakeLib:
        def wass_census_cost(self, *args):
            seen.append((state["current"], args))
            return args[0]

        def wass_cuda_error_string(self, err):
            return b"fake error"

    monkeypatch.setattr(torch.cuda, "device", FakeDevice)
    monkeypatch.setattr(torch.cuda, "current_stream", FakeStream)
    monkeypatch.setattr(_build, "load", lambda: FakeLib())
    assert _build.launch("wass_census_cost", "census_cost kernel", torch.device("cuda", 1), 0, 5) == 0
    assert seen == [("cuda:1", (0, 5, 7001))] and state["current"] == "cuda:0"
    with pytest.raises(RuntimeError, match="census_cost kernel: CUDA error 3"):
        _build.launch("wass_census_cost", "census_cost kernel", torch.device("cuda", 2), 3)
    assert _build.launch("wass_census_cost", "x", torch.device("cuda", 2), 9, accept=(9,)) == 9
