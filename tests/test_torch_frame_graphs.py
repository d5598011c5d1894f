"""The pieces of the dense frame's CUDA graphs that run without a card
(stereo/frame_graphs.py): the plane stage split at its host read, the
RANSAC draws kept on the device, a frame's ring instance, the ring keys
and their cache, and the launch counts a replay adds.  The graphs
themselves run on the card: tests/test_torch_frame_graphs_cuda.py."""

import dataclasses

import numpy as np
import pytest
import torch

from wass_tpu_torch.instrument import LaunchCounts, captured_launches, frame_scope, replay_launches
from wass_tpu_torch.stereo import frame_graphs, sgm_kernels
from wass_tpu_torch.stereo import plane as tplane
from wass_tpu_torch.stereo.dense import (
    DenseStereoConfig,
    plane_normal_read,
    plane_stage,
    plane_stage_device,
    plane_stage_tail,
)


def _cloud(seed, H, W, outliers=0.3):
    """(H, W, 3) points of a tilted plane ~10 units off with noise and a
    share of outliers, and a validity mask with holes."""
    g = torch.Generator().manual_seed(seed)
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32), torch.arange(W, dtype=torch.float32),
                            indexing="ij")
    x = (xx - W / 2) * 0.05
    y = (yy - H / 2) * 0.05
    z = 10.0 + 0.3 * x - 0.2 * y + 0.02 * torch.randn((H, W), generator=g)
    wild = torch.rand((H, W), generator=g) < outliers
    z = torch.where(wild, z + 5.0 * torch.rand((H, W), generator=g), z)
    valid = torch.rand((H, W), generator=g) > 0.2
    return torch.stack([x, y, z], -1), valid


def _plane_stage_whole(pts, valid, cfg):
    """plane_stage as one piece, as it was before the split: RANSAC, crop,
    the weighted refinement with its eigh on the host, the final crop."""
    fit = tplane.ransac_find_plane(pts, valid, cfg.plane_ransac_rounds, cfg.plane_ransac_threshold,
                                   seed=cfg.random_seed)
    valid_c = tplane.crop_plane(fit.plane, pts, valid, cfg.plane_ransac_threshold)
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    dist = torch.sqrt(x * x + y * y + z * z)
    m = valid_c & (dist < cfg.plane_refine_max_distance)
    w = torch.where(m, dist if cfg.plane_weight_by_distance else torch.ones_like(dist), 0.0)
    wsum = torch.clamp_min(w.sum(), 1e-20)
    centroid = torch.einsum("...c,...->c", pts, w) / wsum
    diff = torch.where(m[..., None], pts - centroid, 0.0)
    A = torch.einsum("...i,...j,...->ij", diff, diff, w)
    _evals, evecs = torch.linalg.eigh(A.cpu())
    n = evecs[:, 0]
    n = n / torch.clamp_min(torch.linalg.norm(n), 1e-20)
    n = torch.where(n[2] < 0, -n, n)
    plane = torch.cat([n, -(n * centroid).sum()[None]])
    valid_f = torch.where(fit.ok, tplane.crop_plane(plane, pts, valid, cfg.plane_max_distance), valid_c)
    return torch.where(fit.ok, plane, torch.full_like(plane, float("nan"))), fit.ok, valid_f


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("shape", [(48, 64), (96, 72)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_plane_stage_is_the_whole_one(seed, shape, weighted):
    """The device part, the normal from the host read, then the tail give
    the one-piece stage's plane, fit flag and final mask bit for bit."""
    pts, valid = _cloud(seed, *shape)
    cfg = DenseStereoConfig(random_seed=seed, plane_weight_by_distance=weighted, plane_max_distance=0.5,
                            plane_ransac_threshold=0.2)
    parts = plane_stage_device(pts, valid, cfg)
    plane, ok, valid_f = plane_stage_tail(pts, parts, plane_normal_read(parts), cfg)
    want = _plane_stage_whole(pts, valid, cfg)
    assert bool(ok) and bool(want[1])
    assert torch.equal(plane.view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(valid_f, want[2])
    again = plane_stage(pts, valid, cfg)
    assert torch.equal(again[0].view(torch.int32), plane.view(torch.int32)) and torch.equal(again[2], valid_f)


def test_failed_fit_gives_nan_and_the_crop():
    """A cloud with no plane: the fit fails, the plane is nan and the mask
    the first crop's, in both compositions."""
    g = torch.Generator().manual_seed(5)
    pts = torch.rand((40, 50, 3), generator=g) * 100.0
    valid = torch.ones((40, 50), dtype=torch.bool)
    cfg = DenseStereoConfig(plane_ransac_threshold=0.01)
    parts = plane_stage_device(pts, valid, cfg)
    plane, ok, valid_f = plane_stage_tail(pts, parts, plane_normal_read(parts), cfg)
    want = _plane_stage_whole(pts, valid, cfg)
    assert not bool(ok) and not bool(want[1])
    assert torch.isnan(plane).all() and torch.equal(valid_f, want[2]) and torch.equal(valid_f, parts.valid_c)


@pytest.mark.parametrize("rounds,shape,seed", [(400, (48, 64), 0), (400, (96, 72), 3), (64, (1536, 2048), 7)])
def test_cached_draws_are_draw_pixels(rounds, shape, seed):
    """The draws kept on the device are draw_pixels' picks, made once per
    key, and RANSAC gives the same fit with them as with the picks passed
    in."""
    H, W = shape
    uv = tplane.ransac_draws(rounds, H, W, seed, "cpu")
    assert uv.dtype == torch.int64 and torch.equal(uv, tplane.draw_pixels(rounds, H, W, seed))
    assert tplane.ransac_draws(rounds, H, W, seed, torch.device("cpu")) is uv
    if H * W <= 1 << 16:
        pts, valid = _cloud(seed, H, W)
        fit = tplane.ransac_find_plane(pts, valid, rounds, 0.2, seed=seed)
        ref = tplane.ransac_find_plane(pts, valid, rounds, 0.2, seed=seed, uv=tplane.draw_pixels(rounds, H, W, seed))
        for a, b in zip(fit, ref):
            assert torch.equal(a, b)


def test_cached_draws_follow_a_replaced_draw_function(monkeypatch):
    """A test that puts other picks in draw_pixels' place gets them, not the
    picks kept for the original function."""
    keep = tplane.ransac_draws(16, 20, 30, 0, "cpu")
    other = torch.zeros((16, 3, 2), dtype=torch.int32)
    monkeypatch.setattr(tplane, "draw_pixels", lambda rounds, H, W, seed: other)
    got = tplane.ransac_draws(16, 20, 30, 0, "cpu")
    assert got.dtype == torch.int64 and not got.any() and keep.any()


@pytest.mark.parametrize("n_slots,depth", [(1, 1), (1, 3), (2, 3), (4, 2)])
def test_instance_index(n_slots, depth):
    """Frame i of a slot takes instance (i // n_slots) mod (depth + 1): any
    depth + 1 of a slot's consecutive frames (the ones in flight, and the
    next) use distinct instances, and instance k serves the slot's k-th
    frame first."""
    for slot in range(n_slots):
        frames = list(range(slot, 40, n_slots))
        used = [frame_graphs.instance_index(i, n_slots, depth) for i in frames]
        assert used[: depth + 1] == list(range(depth + 1))
        for k in range(len(used) - depth):
            assert len(set(used[k:k + depth + 1])) == depth + 1
    assert frame_graphs.instance_index(13, 4, 2) == 0 and frame_graphs.instance_index(7, 2, 3) == 3


@pytest.fixture
def rings(monkeypatch):
    monkeypatch.setattr(frame_graphs, "_RINGS", {})
    return frame_graphs._RINGS


BASE = dict(slot=0, device="cpu", shape=(384, 512), dtype=np.uint8, cfg=DenseStereoConfig(num_disp=160),
            geom_key=(b"K0", b"K1", b"R", b"T", (384, 512), "cpu"))
CHANGES = {
    "shape": dict(shape=(192, 256)),
    "config": dict(cfg=DenseStereoConfig(num_disp=160, input_smooth_sigma=0.8)),
    "rig": dict(geom_key=(b"K0", b"K1", b"R2", b"T", (384, 512), "cpu")),
    "slot": dict(slot=1),
    "device": dict(device="cuda:1"),
    "dtype": dict(dtype=np.uint16),
}


@pytest.mark.parametrize("what", sorted(CHANGES) + ["h2"])
def test_key_changes(rings, what, monkeypatch):
    """A new shape, configuration, rig, slot, device, image type or H2
    switch is a new key and a new ring; the same key is the same ring."""
    first = frame_graphs.ring_for(**BASE, geom_pack={})
    assert frame_graphs.ring_for(**BASE, geom_pack={"other": 1}) is first
    if what == "h2":
        monkeypatch.setattr(sgm_kernels, "_USE_H2", True)
        args = BASE
    else:
        args = {**BASE, **CHANGES[what]}
    second = frame_graphs.ring_for(**args, geom_pack={})
    assert second is not first and second.key != first.key
    assert frame_graphs.ring_key(**args) == second.key


def test_cache_keeps_two_keys_a_slot(rings):
    """A slot keeps its newest two keys (a hit counts as new); another slot
    keeps its own."""
    def key(n):
        return {**BASE, "geom_key": ("rig", n)}

    made = [frame_graphs.ring_for(**key(n), geom_pack={}) for n in range(5)]
    slot0 = rings[(0, "cpu")]
    assert len(slot0) == frame_graphs.KEYS_PER_SLOT == 2
    assert list(slot0.values()) == made[3:]
    assert frame_graphs.ring_for(**key(3), geom_pack={}) is made[3]
    frame_graphs.ring_for(**key(5), geom_pack={})
    assert made[3] in slot0.values() and made[4] not in slot0.values()
    other = frame_graphs.ring_for(**{**key(0), "slot": 1}, geom_pack={})
    assert len(rings[(1, "cpu")]) == 1 and len(slot0) == 2 and other is not made[0]
    ring = made[3]
    assert ring.slot == 0 and ring.shape == (384, 512) and ring.dtype == np.uint8 and not ring.instances


def test_graphs_engage_on_a_card_only():
    assert frame_graphs.engages("cuda:0") and frame_graphs.engages(torch.device("cuda"))
    assert not frame_graphs.engages("cpu")


def test_replay_adds_the_captured_launches():
    """Launches made inside a capture are recorded, not counted; each replay
    counts them for the thread's frame and in the totals, as the eager
    calls would be."""
    a = LaunchCounts({"census": 0, "census_cost": 0})
    b = LaunchCounts({"label_propagate": 0})
    eager: dict = {}
    with frame_scope(eager):
        for key in ("census", "census", "census_cost"):
            a.add(key)
        b.add("label_propagate")
    a.reset()
    b.reset()
    frame: dict = {}
    with frame_scope(frame):
        with captured_launches() as recorded:
            for key in ("census", "census", "census_cost"):
                a.add(key)
            b.add("label_propagate")
        assert frame == {} and not any(a.values()) and not any(b.values())
        assert len(recorded) == 4
        replay_launches(recorded)
    assert frame == eager == {"census": 2, "census_cost": 1, "label_propagate": 1}
    assert dict(a) == {"census": 2, "census_cost": 1} and dict(b) == {"label_propagate": 1}
    second: dict = {}
    with frame_scope(second):
        replay_launches(recorded)
    assert second == eager and a["census"] == 4 and b["label_propagate"] == 2


def test_nested_capture_keeps_the_outer_record():
    a = LaunchCounts({"census": 0})
    with captured_launches() as outer:
        a.add("census")
        with captured_launches() as inner:
            a.add("census")
        a.add("census")
    assert len(outer) == 2 and len(inner) == 1 and a["census"] == 0
    a.add("census")
    assert a["census"] == 1


def test_configs_hash_as_keys():
    """The frozen configuration keys a ring: equal settings, equal keys."""
    c1 = DenseStereoConfig(num_disp=160)
    c2 = dataclasses.replace(DenseStereoConfig(), num_disp=160)
    assert hash(c1) == hash(c2) and frame_graphs.ring_key(0, "cpu", (8, 8), np.uint8, c1, None) == \
        frame_graphs.ring_key(0, "cpu", (8, 8), np.uint8, c2, None)


def test_static_outputs_copy_all_but_the_inputs():
    """A capture's outputs (frame_graphs._capture's tree walk, here without
    a graph): each tensor is copied into its static place, but a tensor
    that is one of the graph's inputs stays itself; other leaves stay."""
    from wass_tpu_torch.stereo.dense import DenseFrameResult

    points, plane = torch.arange(6.0).reshape(1, 2, 3), torch.tensor([0.0, 0.0, 1.0, -5.0])
    out = DenseFrameResult(points=points, valid=torch.tensor([[True, False]]), plane=plane, plane_ok=torch.tensor(True),
                           disparity=torch.ones(1, 2), n_points=torch.tensor(1), fail_reasons=None)
    static = frame_graphs._map(torch.empty_like, out)
    inputs = {id(t) for t in frame_graphs._leaves((points, {"c2f": None}))}

    def keep(s, t):
        return t if id(t) in inputs else s.copy_(t)

    got = frame_graphs._map(keep, static, out)
    assert type(got) is DenseFrameResult and got.fail_reasons is None and got.points is points
    for name in ("valid", "plane", "plane_ok", "disparity", "n_points"):
        assert getattr(got, name) is getattr(static, name) and torch.equal(getattr(got, name), getattr(out, name))
    nested = frame_graphs._map(lambda t: t + 1, {"a": (torch.zeros(2), None), "b": "x"})
    assert torch.equal(nested["a"][0], torch.ones(2)) and nested["a"][1] is None and nested["b"] == "x"
    assert len(frame_graphs._leaves(out)) == 6
