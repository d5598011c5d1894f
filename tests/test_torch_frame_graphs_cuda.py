"""The stereo loop's CUDA graphs on the card (stereo/frame_graphs.py): the
loop that replays each frame from a ring of graph instances against the
same loop run eagerly (frame_graphs.engages replaced), frame by frame and
file by file, with one slot and with two slots on one card, a rig that
changes mid-sequence, and a shape that fails the c2f gate (the full-range
branch in graph D, with its counters); the frame's .xyzC export as graph
F's static outputs, written anew at every replay.

Marked `cuda`: they need an NVIDIA GPU and nvcc and skip without them.
Run them on the GPU machine, which has no jax for the shared conftest, with
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_frame_graphs_cuda.py -q
"""

import gc
import io
import weakref

import numpy as np
import pytest
import torch

from wass_tpu_torch.cli.main import load_pipeline
from wass_tpu_torch.cli.pipeline import SequencePipeline
from wass_tpu_torch.parallel.mesh import make_frame_mesh
from wass_tpu_torch.stereo import frame_graphs
from wass_tpu_torch.testing import write_pairs
from wass_tpu_torch.testing.synthetic import make_rig, make_scene

pytestmark = pytest.mark.cuda

# A c2f shape: the coarse pass at 96x128 over 40 disparities, windows of
# 128 over the 160 of the full range.
W, H = 512, 384
CONFIG = "MAX_DISPARITY=160\n"
N_FRAMES = 6
# A ragged full-range shape: 392 % 32 = 8 fails the c2f gate, so K1 and K3
# run over the 160 disparities; 392 rows end in a partial census tile.
H_FULL = 392


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def fresh_rings(monkeypatch):
    """No ring of an earlier test: every ring here is captured here."""
    monkeypatch.setattr(frame_graphs, "_RINGS", {})


def _pairs(height=H):
    rig = make_rig(width=W, height=height)
    scenes = [make_scene(seed=3, width=W, height=height, wave_amplitude=0.25, rig=rig, time=k / 15.0)
              for k in range(3)]
    pairs = [tuple(np.clip(img, 0, 255).astype(np.uint8) for img in (s.img0, s.img1)) for s in scenes]
    return [pairs[i % 3] for i in range(N_FRAMES)], rig


def _tilt(wd, deg: float) -> None:
    """The workdir's rig turned by `deg` about the cameras' y axis: another
    rig, another geometry key."""
    R, T = wd.load_extrinsics()
    a = np.deg2rad(deg)
    Ry = np.array([[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0], [-np.sin(a), 0.0, np.cos(a)]])
    wd.save_extrinsics(Ry @ R, T)


def _run(tmp_path, name, monkeypatch, graphs: bool, slots: int = 1, depth: int = 3, tilted=(), height=H,
         scribble=None):
    """The loop over the frames; returns (every frame's tensors and c2f
    scalars as its writer received them, every file, loop_stats).  With a
    list `scribble`, each writer appends (its frame, the addresses of its
    export's payload and header) and, after its reads, overwrites both (the
    payload with -1, the header with nan) on its stream."""
    from wass_tpu_torch.io.workdir import Workdir

    pairs, rig = _pairs(height)
    seq = tmp_path / name
    wds = [Workdir(p) for p in write_pairs(seq, pairs, rig)]
    for k in tilted:
        _tilt(wds[k], 0.3)
    (seq / "stereo_config.txt").write_text(CONFIG)
    kept = {}
    finalize = SequencePipeline._finalize_stereo_frame

    def keep(self, wd, geom, res, K0, K1, extras, whole):
        c2f = extras["c2f"]
        kept[wd.path.name] = {
            **{f: getattr(res, f).cpu().clone() for f in ("points", "valid", "plane", "disparity", "fail_reasons")},
            **({} if c2f is None else {"coverage": float(c2f["coverage"]), "offband": float(c2f["offband"])}),
        }
        plane = finalize(self, wd, geom, res, K0, K1, extras, whole)
        if scribble is not None:
            ex = extras["export"]
            scribble.append((wd.path.name, (ex.payload.data_ptr(), ex.header.data_ptr())))
            ex.payload.fill_(-1)
            ex.header.fill_(float("nan"))
        return plane

    monkeypatch.setattr(SequencePipeline, "_finalize_stereo_frame", keep)
    monkeypatch.setattr(frame_graphs, "engages", lambda device: graphs)
    try:
        pipe = load_pipeline(seq, "cuda")
        pipe.cfg.dispatch_depth = depth
        if slots > 1:
            pipe._frame_mesh = lambda: make_frame_mesh(devices=[torch.device("cuda")] * slots)
        pipe.stereo(progress_stream=io.StringIO())
    finally:
        monkeypatch.setattr(SequencePipeline, "_finalize_stereo_frame", finalize)
    files = {}
    for wd in wds:
        for f in sorted(wd.path.iterdir()):
            if f.is_file() and f.name not in ("ext_R.xml", "ext_T.xml"):
                data = f.read_bytes()
                if f.name == "wass_stereo_log.txt":
                    data = b"\n".join(ln for ln in data.splitlines() if b"wall time" not in ln)
                files[f"{wd.path.name}/{f.name}"] = data
    files["planes.txt"] = (seq / "output" / "planes.txt").read_bytes()
    return kept, files, pipe.loop_stats


def _same(graph, eager, full_range=False):
    (kg, fg, _), (ke, fe, _) = graph, eager
    assert sorted(kg) == sorted(ke) and len(kg) == N_FRAMES
    for name in ke:
        for field, want in ke[name].items():
            got = kg[name][field]
            if isinstance(want, torch.Tensor):
                assert got.dtype == want.dtype and torch.equal(got.view(-1).view(torch.uint8),
                                                               want.view(-1).view(torch.uint8)), (name, field)
            else:
                assert got == want, (name, field)
    assert sorted(fg) == sorted(fe)
    differ = [k for k in fe if fg[k] != fe[k]]
    assert not differ, differ
    logs = [v for k, v in fg.items() if k.endswith("wass_stereo_log.txt")]
    if full_range:
        assert all(b"c2f window" not in v and b"sgm_wta_fused=1" in v and b"sgm_wta_fused_windowed=0" in v
                   for v in logs)
    else:
        assert all(b"windowed" in v and b"sgm_wta_fused_windowed=1" in v for v in logs)


@pytest.mark.parametrize("slots", [1, 2])
def test_graph_loop_equals_the_eager_loop(dev, tmp_path, monkeypatch, fresh_rings, slots):
    """Six c2f frames through rings of depth 3 (one slot, or two slots on
    the card): points, valid, plane, disparity, fail reasons, the c2f
    scalars, every file (the renders and the launch lines included) equal
    the eager loop's; each frame replays, each instance is captured once."""
    graph = _run(tmp_path, "graph", monkeypatch, True, slots)
    eager = _run(tmp_path, "eager", monkeypatch, False, slots)
    _same(graph, eager)
    stats = graph[2]
    assert stats["dense_graph_replays"] == [1.0] * N_FRAMES
    per_slot = [sum(1 for i in range(s, N_FRAMES, slots)) for s in range(slots)]
    assert sum(stats["dense_graph_captures"]) == sum(min(n, 4) for n in per_slot)
    assert "dense_graph_replays" not in eager[2] and "dense_graph_captures" not in eager[2]
    assert stats["host_reads"] == [1.0] * N_FRAMES
    # A second call on the same key replays with no capture.
    monkeypatch.setattr(frame_graphs, "engages", lambda device: True)
    pipe = load_pipeline(tmp_path / "graph", "cuda")
    if slots > 1:
        pipe._frame_mesh = lambda: make_frame_mesh(devices=[torch.device("cuda")] * slots)
    pipe.stereo(progress_stream=io.StringIO())
    assert pipe.loop_stats["dense_graph_replays"] == [1.0] * N_FRAMES
    assert sum(pipe.loop_stats.get("dense_graph_captures", [0.0])) == 0


def test_full_range_graph_loop_equals_the_eager_loop(dev, tmp_path, monkeypatch, fresh_rings):
    """Six frames at 512x392 through a ring of depth 3: graph D holds the
    full-range branch (K1, K3 at D = 160, ragged census tiles); every
    tensor and file equals the eager loop's.  Both loops count
    dense_full_range 1 a frame; dense_graph_pool_bytes reads the ring's
    pool, the same on every frame and again on every frame of a second
    call, and 0 in the eager loop."""
    graph = _run(tmp_path, "graph", monkeypatch, True, height=H_FULL)
    eager = _run(tmp_path, "eager", monkeypatch, False, height=H_FULL)
    _same(graph, eager, full_range=True)
    stats, plain = graph[2], eager[2]
    assert stats["dense_full_range"] == plain["dense_full_range"] == [1.0] * N_FRAMES
    assert stats["dense_graph_replays"] == [1.0] * N_FRAMES
    assert plain["dense_graph_pool_bytes"] == [0.0] * N_FRAMES
    pool = stats["dense_graph_pool_bytes"]
    assert pool[0] > 0 and pool == [pool[0]] * N_FRAMES, pool
    monkeypatch.setattr(frame_graphs, "engages", lambda device: True)
    pipe = load_pipeline(tmp_path / "graph", "cuda")
    pipe.stereo(progress_stream=io.StringIO())
    assert sum(pipe.loop_stats.get("dense_graph_captures", [0.0])) == 0
    assert pipe.loop_stats["dense_graph_pool_bytes"] == pool
    assert pipe.loop_stats["dense_full_range"] == [1.0] * N_FRAMES


def test_new_rig_captures_a_new_ring(dev, tmp_path, monkeypatch, fresh_rings):
    """Depth 1 (two instances a ring): frames 0-1 capture, 2-3 replay, and
    frames 4-5, whose rig differs, capture a ring of their own; every frame
    equals the eager loop's."""
    graph = _run(tmp_path, "graph", monkeypatch, True, depth=1, tilted=(4, 5))
    eager = _run(tmp_path, "eager", monkeypatch, False, depth=1, tilted=(4, 5))
    _same(graph, eager)
    stats = graph[2]
    assert stats["dense_graph_captures"] == [1.0, 1.0, 0.0, 0.0, 1.0, 1.0]
    assert stats["dense_graph_replays"] == [1.0] * N_FRAMES
    rings = frame_graphs._RINGS[(0, "cuda:0")]
    assert len(rings) == 2 and all(len(r.instances) == 2 for r in rings.values())


def test_evicted_rings_free_their_memory(dev, tmp_path, monkeypatch, fresh_rings):
    """Five stereo() calls, each with a rig of its own: the cache keeps the
    newest two rings, an evicted ring is gone, and the card's reserved
    memory does not grow with the calls."""
    pairs, rig = _pairs()
    monkeypatch.setattr(frame_graphs, "engages", lambda device: True)
    first, reserved = None, []
    for k in range(5):
        from wass_tpu_torch.io.workdir import Workdir

        seq = tmp_path / f"rig{k}"
        wds = [Workdir(p) for p in write_pairs(seq, pairs[:2], rig)]
        for wd in wds:
            _tilt(wd, 0.1 * k)
        (seq / "stereo_config.txt").write_text(CONFIG)
        pipe = load_pipeline(seq, "cuda")
        pipe.stereo(progress_stream=io.StringIO())
        assert pipe.loop_stats["dense_graph_replays"] == [1.0, 1.0]
        assert pipe.loop_stats["dense_graph_captures"] == [1.0, 1.0]
        rings = frame_graphs._RINGS[(0, "cuda:0")]
        if first is None:
            first = weakref.ref(next(iter(rings.values())))
        gc.collect()
        reserved.append(torch.cuda.memory_reserved())
        assert len(rings) == min(k + 1, frame_graphs.KEYS_PER_SLOT)
    assert first() is None
    assert reserved[-1] <= 2 * reserved[1], reserved


@pytest.mark.parametrize("height", [H, H_FULL], ids=["c2f", "full_range"])
def test_graph_f_writes_the_export_every_replay(dev, tmp_path, monkeypatch, fresh_rings, height):
    """The export's payload and header are graph F's static outputs: frames
    k and k + 4 of a ring of depth 3 get the same two tensors, other frames
    others.  Each writer overwrites its frame's export after its two reads,
    yet every frame's .xyzC and plane.txt (every file) equal the eager
    loop's, in the c2f and the full-range branch: each replay of F writes
    the export anew."""
    seen = []
    graph = _run(tmp_path, "graph", monkeypatch, True, height=height, scribble=seen)
    eager = _run(tmp_path, "eager", monkeypatch, False, height=height)
    _same(graph, eager, full_range=height == H_FULL)
    ptrs = dict(seen)
    names = sorted(ptrs)
    assert len(names) == N_FRAMES
    for k, a in enumerate(names):
        for j, b in enumerate(names):
            assert (ptrs[a] == ptrs[b]) == (k % 4 == j % 4), (a, b)
    for stats in (graph[2], eager[2]):
        assert stats["writer_host_reads"] == [2.0] * N_FRAMES
    # The plane's read lands in pinned memory: a pageable one would hold
    # the CUDA driver, and the writers' reads with it, until D ends.
    (ring,) = frame_graphs._RINGS[(0, "cuda:0")].values()
    assert len(ring.instances) == 4 and all(inst.cov_staging.is_pinned() for inst in ring.instances.values())
