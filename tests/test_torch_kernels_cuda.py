"""The CUDA kernels against their plain versions on the card.

Marked `cuda`: they need an NVIDIA GPU and nvcc and skip without them.
Run them on the GPU machine, which has no jax for the shared conftest, with
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py -q
(chip_smoke.py checks the same kernels at the full 3 MP shapes)."""

import pytest
import torch

import wass_tpu_torch
from wass_tpu_torch.match import iidyn as im
from wass_tpu_torch.ops import components_kernels as ck
from wass_tpu_torch.post import geometry as pg
from wass_tpu_torch.post import visibility_kernels as vk
from wass_tpu_torch.stereo import sgm_kernels as sk
from wass_tpu_torch.stereo import sgm as plain_sgm
from wass_tpu_torch.stereo.cost import census_cost_volume, census_cost_volume_windowed, census_transform
from wass_tpu_torch.stereo.sgm import sgm_wta_fused_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _census_pair(dev, h, w, seed, win=(7, 9)):
    g = torch.Generator().manual_seed(seed)
    a, b = (torch.rand((h, w), generator=g) * 255 for _ in range(2))
    return census_transform(a.to(dev), win, 0.8), census_transform(b.to(dev), win, 0.8)


# D 32, 36, 52, 96 and 160 take lane widths V = 1, 2, 2, 4 and 8 (160 is
# the coarse pass's D at the stereo defaults).
SHAPES = [(48, 64, 32, 1), (37, 101, 36, 3), (101, 77, 52, 1), (61, 70, 96, 0), (48, 61, 160, 1)]


@pytest.mark.parametrize("h,w,d,min_disp", SHAPES)
def test_census_cost_kernel(dev, h, w, d, min_disp):
    cb, cm = _census_pair(dev, h, w, h)
    assert torch.equal(sk.census_cost_volume(cb, cm, d, min_disp), census_cost_volume(cb, cm, d, min_disp))


# K1's edges: census words nw = 1 (5x5), 2 (7x9) and 3 (9x9); D % 4 != 0;
# min_disp 0 and > 0; W < min_disp + D (a column with no match in range,
# and a volume all max_cost); W not a multiple of the tile; W*D not a
# multiple of 16 (plain stores in place of the bulk copy); D large enough
# to narrow the tile to 32 and 16 columns.
CENSUS_EDGES = [(5, 70, (5, 5), 13, 0), (6, 130, (9, 9), 37, 2), (4, 50, (7, 9), 90, 20), (3, 64, (9, 9), 640, 1),
                (3, 257, (5, 5), 7, 300), (2, 1001, (7, 9), 52, 1), (3, 99, (7, 9), 41, 0), (2, 33, (9, 9), 3000, 0),
                (2, 200, (7, 9), 1100, 5)]


@pytest.mark.parametrize("h,w,win,d,min_disp", CENSUS_EDGES)
def test_census_cost_kernel_edges(dev, h, w, win, d, min_disp):
    cb, cm = _census_pair(dev, h, w, h * w + d, win)
    assert torch.equal(sk.census_cost_volume(cb, cm, d, min_disp), census_cost_volume(cb, cm, d, min_disp))


# K2's edges: nw 1-3, Dw % 16 != 0, W not a multiple of the tile, and window
# starts that put whole tiles (or the whole row) below x - d < 0.
WINDOWED_CENSUS_EDGES = [(16, 70, (5, 5), 20, [0, 80]), (16, 130, (9, 9), 52, [3, 0]), (8, 257, (7, 9), 128, [260]),
                         (24, 100, (9, 9), 12, [0, 150, 7]), (16, 1001, (7, 9), 52, [1, 149])]


@pytest.mark.parametrize("h,w,win,dw,ws", WINDOWED_CENSUS_EDGES)
def test_census_cost_windowed_kernel_edges(dev, h, w, win, dw, ws):
    cb, cm = _census_pair(dev, h, w, h * w + dw, win)
    ws = torch.tensor(ws, dtype=torch.int32, device=dev)
    assert torch.equal(sk.census_cost_volume_windowed(cb, cm, ws, dw), census_cost_volume_windowed(cb, cm, ws, dw))


@pytest.mark.parametrize("h,w,d,min_disp", SHAPES)
@pytest.mark.parametrize("directions,uniq", [(5, 1), (8, 1), (8, 5)])
def test_sgm_wta_fused_kernel(dev, h, w, d, min_disp, directions, uniq):
    cb, cm = _census_pair(dev, h, w, h + 1)
    cost = sk.census_cost_volume(cb, cm, d, min_disp)
    out = sk.sgm_wta_fused(cost, 8, 96, directions, min_disp, uniq)
    assert torch.equal(out, sgm_wta_fused_plain(cost, 8, 96, directions, min_disp, uniq))


@pytest.mark.parametrize("h,w,density", [(64, 128, 0.6), (77, 101, 0.45), (200, 300, 0.3)])
def test_label_propagate_kernel(dev, h, w, density):
    g = torch.Generator().manual_seed(h)
    valid = (torch.rand((h, w), generator=g) > density).to(dev)
    init = torch.where(valid, torch.arange(h * w, dtype=torch.int32, device=dev).reshape(h, w), 2**31 - 1)
    conn_v = torch.zeros((h, w), dtype=torch.uint8, device=dev)
    conn_h = torch.zeros_like(conn_v)
    conn_v[1:] = (valid[1:] & valid[:-1]).to(torch.uint8)
    conn_h[:, 1:] = (valid[:, 1:] & valid[:, :-1]).to(torch.uint8)
    for rounds in (1, 24):
        assert torch.equal(ck.propagate_labels(init, conn_v, conn_h, rounds),
                           ck.propagate_labels_plain(init, conn_v, conn_h, rounds))


def _serpentine(h, w, every):
    """Bands every `every` rows joined at alternating ends: the smallest
    label crosses about one band a round."""
    mask = torch.zeros((h, w), dtype=torch.bool)
    mask[::every] = True
    for k, r in enumerate(range(0, h, every)):
        mask[r:r + every, w - 1 if k % 2 == 0 else 0] = True
    return mask


def _discs(h, w, seed):
    """A union of 8 random discs: components that converge in 1-3 rounds."""
    g = torch.Generator().manual_seed(seed)
    yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    mask = torch.zeros((h, w), dtype=torch.bool)
    for _ in range(8):
        cy, cx = (torch.rand(2, generator=g) * torch.tensor([h, w])).tolist()
        r = 4 + float(torch.rand(1, generator=g)) * min(h, w) / 4
        mask |= (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
    return mask


def _plain_rounds_changed(init, conn_v, conn_h, rounds):
    """Rounds of the plain propagation that change a label, one at a time."""
    cur, changed = init, 0
    for _ in range(rounds):
        nxt = ck.propagate_labels_plain(cur, conn_v, conn_h, 1)
        if torch.equal(nxt, cur):
            break
        cur, changed = nxt, changed + 1
    return changed


@pytest.mark.parametrize("kind,h,w", [("discs", 96, 128), ("discs", 61, 203), ("discs", 300, 41),
                                      ("serpentine", 200, 40), ("serpentine", 160, 1030)])
def test_label_propagate_early_exit(dev, kind, h, w):
    """Bit-equal to the plain version on masks that converge in a few
    rounds (the launches after a round that changes nothing return at
    once) and on ones that need every round; the device flags count the
    rounds that changed labels."""
    if kind == "discs":
        valid = _discs(h, w, h + w)
    else:
        valid = _serpentine(h, w, 2 if w < 100 else 4)
    valid = valid.to(dev)
    init = torch.where(valid, torch.arange(h * w, dtype=torch.int32, device=dev).reshape(h, w), 2**31 - 1)
    conn_v = torch.zeros((h, w), dtype=torch.uint8, device=dev)
    conn_h = torch.zeros_like(conn_v)
    conn_v[1:] = (valid[1:] & valid[:-1]).to(torch.uint8)
    conn_h[:, 1:] = (valid[:, 1:] & valid[:, :-1]).to(torch.uint8)
    out = ck.propagate_labels(init, conn_v, conn_h, 24)
    assert torch.equal(out, ck.propagate_labels_plain(init, conn_v, conn_h, 24))
    changed = ck.rounds_changed()
    assert changed == _plain_rounds_changed(init, conn_v, conn_h, 24)
    assert 1 <= changed <= 3 if kind == "discs" else changed == 24


# Lines shorter than the walks' prefetch depth: rows of W < 8 pixels,
# diagonals of one pixel (W = 1), at lane widths 1, 4 and 8.
SHORT_SHAPES = [(8, 3, 32, 1), (8, 1, 96, 0), (5, 7, 160, 1), (16, 2, 128, 1)]


@pytest.mark.parametrize("h,w,d,min_disp", SHORT_SHAPES)
def test_sgm_short_lines(dev, h, w, d, min_disp):
    cb, cm = _census_pair(dev, h, w, h + w)
    cost = sk.census_cost_volume(cb, cm, d, min_disp)
    for directions in (5, 8):
        assert torch.equal(sk.sgm_wta_fused(cost, 8, 96, directions, min_disp, 1),
                           sgm_wta_fused_plain(cost, 8, 96, directions, min_disp, 1))
    for directions in (2, 4, 5, 8):
        assert torch.equal(sk.sgm_aggregate(cost, 8, 96, directions), plain_sgm.sgm_aggregate(cost, 8, 96, directions))
    for walk in plain_sgm.WALKS:
        acc = torch.randint(-99, 99, cost.shape, dtype=torch.int16, device=dev)
        assert torch.equal(sk.sgm_walk_add(cost, acc.clone(), walk, 8, 96),
                           plain_sgm.walk_add(cost, acc.clone(), walk, 8, 96))


def _jumping_windows(dev, n_tiles, dw):
    """Window starts that jump by more than dw at the first and at the last
    tile boundary (a single tile keeps one start)."""
    ws = [3] + [3 + dw + 4] * (n_tiles - 1)
    if n_tiles >= 3:
        ws[-1] = 0
    return torch.tensor(ws, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("h,w,dw", [(8, 3, 32), (8, 1, 128), (16, 5, 96), (24, 7, 128), (24, 2, 160), (32, 40, 128)])
def test_windowed_short_lines_and_jumps(dev, h, w, dw):
    cb, cm = _census_pair(dev, h, w, h * w)
    ws = _jumping_windows(dev, h // 8, dw)
    cost = sk.census_cost_volume_windowed(cb, cm, ws, dw)
    for directions in (5, 8):
        assert torch.equal(sk.sgm_wta_fused_windowed(cost, ws, 8, 96, directions, 1),
                           plain_sgm.sgm_wta_fused_windowed_plain(cost, ws, 8, 96, directions, 1))
    for directions in (2, 5, 8):
        assert torch.equal(sk.sgm_aggregate_windowed(cost, ws, 8, 96, directions),
                           plain_sgm.sgm_aggregate_windowed(cost, ws, 8, 96, directions))
    for walk in plain_sgm.WALKS:
        acc = torch.randint(-99, 99, cost.shape, dtype=torch.int16, device=dev)
        assert torch.equal(sk.sgm_walk_add(cost, acc.clone(), walk, 8, 96, ws),
                           plain_sgm.walk_add(cost, acc.clone(), walk, 8, 96, ws))
    partial = torch.randint(0, 300, cost.shape, dtype=torch.int16, device=dev)
    for reverse in (False, True):
        assert torch.equal(sk.sgm_tri_dir_wta_windowed(cost, partial.clone(), ws, 8, 96, reverse, 1),
                           plain_sgm.run_tri_dir_wta_windowed_plain(cost, partial.clone(), ws, 8, 96, reverse, 1))


@pytest.mark.parametrize("h,w,d,min_disp", SHAPES)
@pytest.mark.parametrize("directions", [2, 4, 5, 8])
def test_sgm_aggregate_kernel(dev, h, w, d, min_disp, directions):
    cb, cm = _census_pair(dev, h, w, h + 2)
    cost = sk.census_cost_volume(cb, cm, d, min_disp)
    assert torch.equal(sk.sgm_aggregate(cost, 8, 96, directions), plain_sgm.sgm_aggregate(cost, 8, 96, directions))


def _windows(dev, h, dw, seed):
    """Random per-tile window starts with a flat step, and jumps up and
    down of at least dw (every realignment case of the windowed walks)."""
    g = torch.Generator().manual_seed(seed)
    ws = torch.randint(0, 3 * dw, (h // 8,), generator=g, dtype=torch.int32)
    if len(ws) >= 4:
        ws[1] = ws[0]
        ws[2], ws[3] = ws[1] + dw + 3, max(0, int(ws[1]) - 2)
    return ws.to(dev)


WINDOWED_SHAPES = [(h // 8 * 8, w, d) for h, w, d, _ in SHAPES]


@pytest.mark.parametrize("h,w,dw", WINDOWED_SHAPES)
def test_windowed_kernels(dev, h, w, dw):
    cb, cm = _census_pair(dev, h, w, h + 3)
    ws = _windows(dev, h, dw, h)
    cost = sk.census_cost_volume_windowed(cb, cm, ws, dw)
    assert torch.equal(cost, census_cost_volume_windowed(cb, cm, ws, dw))
    for directions in (5, 8):
        for uniq in (1, 5):
            out = sk.sgm_wta_fused_windowed(cost, ws, 8, 96, directions, uniq)
            assert torch.equal(out, plain_sgm.sgm_wta_fused_windowed_plain(cost, ws, 8, 96, directions, uniq))
    for directions in (2, 5, 8):
        out = sk.sgm_aggregate_windowed(cost, ws, 8, 96, directions)
        assert torch.equal(out, plain_sgm.sgm_aggregate_windowed(cost, ws, 8, 96, directions))


@pytest.mark.parametrize("h,w,d,min_disp", SHAPES)
def test_h2_kernels(dev, monkeypatch, h, w, d, min_disp):
    """The H2 pair and folding walks, and the single walks of the H2
    compositions, against their plain versions; the public entry points
    with _USE_H2 against their default path."""
    cb, cm = _census_pair(dev, h, w, h + 4)
    cost = sk.census_cost_volume(cb, cm, d, min_disp)
    hf, hb = sk.sgm_pair_img(cost, 8, 96)
    phf, phb = plain_sgm.run_pair_img_plain(cost, 8, 96)
    assert torch.equal(hf, phf) and torch.equal(hb, phb)
    for reverse in (False, True):
        partial = plain_sgm.run_tri_dir_partial_h2_plain(cost, hf, hb, 8, 96, not reverse)
        assert torch.equal(sk.sgm_tri_dir_partial_h2(cost, hf, hb, 8, 96, not reverse), partial)
        for uniq in (1, 5):
            assert torch.equal(sk.sgm_tri_dir_wta_h2(cost, hf, hb, 8, 96, reverse, min_disp, uniq),
                               plain_sgm.run_tri_dir_wta_h2_plain(cost, hf, hb, 8, 96, reverse, min_disp, uniq))
        assert torch.equal(sk.sgm_tri_dir_wta(cost, partial.clone(), 8, 96, reverse, min_disp, 1),
                           plain_sgm.run_tri_dir_wta_plain(cost, partial.clone(), 8, 96, reverse, min_disp, 1))
    for walk in plain_sgm.WALKS:
        acc = torch.randint(-99, 99, cost.shape, dtype=torch.int16, device=dev)
        assert torch.equal(sk.sgm_walk_add(cost, acc.clone(), walk, 8, 96),
                           plain_sgm.walk_add(cost, acc.clone(), walk, 8, 96))
    default = [sk.sgm_wta_fused(cost, 8, 96, n, min_disp, 1) for n in (5, 8)]
    default += [sk.sgm_aggregate(cost, 8, 96, n) for n in (2, 4, 5, 8)]
    monkeypatch.setattr(sk, "_USE_H2", True)
    h2 = [sk.sgm_wta_fused(cost, 8, 96, n, min_disp, 1) for n in (5, 8)]
    h2 += [sk.sgm_aggregate(cost, 8, 96, n) for n in (2, 4, 5, 8)]
    assert all(torch.equal(a, b) for a, b in zip(h2, default))


@pytest.mark.parametrize("h,w,dw", WINDOWED_SHAPES)
def test_h2_windowed_kernels(dev, monkeypatch, h, w, dw):
    cb, cm = _census_pair(dev, h, w, h + 5)
    ws = _windows(dev, h, dw, h + 1)
    cost = sk.census_cost_volume_windowed(cb, cm, ws, dw)
    hf, hb = sk.sgm_pair_img(cost, 8, 96)
    for reverse in (False, True):
        partial = plain_sgm.run_tri_dir_partial_windowed_h2_plain(cost, hf, hb, ws, 8, 96, not reverse)
        assert torch.equal(sk.sgm_tri_dir_partial_windowed_h2(cost, hf, hb, ws, 8, 96, not reverse), partial)
        for uniq in (1, 5):
            assert torch.equal(sk.sgm_tri_dir_wta_windowed_h2(cost, hf, hb, ws, 8, 96, reverse, uniq),
                               plain_sgm.run_tri_dir_wta_windowed_h2_plain(cost, hf, hb, ws, 8, 96, reverse, uniq))
        assert torch.equal(sk.sgm_tri_dir_wta_windowed(cost, partial.clone(), ws, 8, 96, reverse, 1),
                           plain_sgm.run_tri_dir_wta_windowed_plain(cost, partial.clone(), ws, 8, 96, reverse, 1))
        acc = torch.randint(-99, 99, cost.shape, dtype=torch.int16, device=dev)
        walk = "bwd" if reverse else "fwd"
        assert torch.equal(sk.sgm_walk_add(cost, acc.clone(), walk, 8, 96, ws),
                           plain_sgm.walk_add(cost, acc.clone(), walk, 8, 96, ws))
    default = [sk.sgm_wta_fused_windowed(cost, ws, 8, 96, n, 1) for n in (5, 8)]
    default += [sk.sgm_aggregate_windowed(cost, ws, 8, 96, n) for n in (2, 5, 8)]
    monkeypatch.setattr(sk, "_USE_H2", True)
    h2 = [sk.sgm_wta_fused_windowed(cost, ws, 8, 96, n, 1) for n in (5, 8)]
    h2 += [sk.sgm_aggregate_windowed(cost, ws, 8, 96, n) for n in (2, 5, 8)]
    assert all(torch.equal(a, b) for a, b in zip(h2, default))


def test_wrappers_count_launches_and_check_inputs(dev, monkeypatch):
    cb, cm = _census_pair(dev, 16, 40, 0)
    ws = torch.tensor([1, 4], dtype=torch.int32, device=dev)
    wass_tpu_torch.reset_launch_counts()
    cost = sk.census_cost_volume(cb, cm, 8, 1)
    sk.sgm_wta_fused(cost, 8, 96, 8, 1, 1)
    counts = wass_tpu_torch.launch_counts()
    assert counts == {**{k: 0 for k in counts}, "census_cost": 1, "sgm_wta_fused": 1}
    assert {"label_propagate", "census_cost_windowed", "sgm_wta_fused_windowed", "sgm_aggregate",
            "sgm_aggregate_windowed", "sgm_walk"} <= set(counts)
    sk.sgm_aggregate(cost, 8, 96, 4)
    wcost = sk.census_cost_volume_windowed(cb, cm, ws, 8)
    sk.sgm_wta_fused_windowed(wcost, ws, 8, 96, 5, 1)
    sk.sgm_aggregate_windowed(wcost, ws, 8, 96, 2)
    counts = wass_tpu_torch.launch_counts()
    k1_k6 = ("census_cost", "census_cost_windowed", "sgm_wta_fused", "sgm_wta_fused_windowed", "sgm_aggregate",
             "sgm_aggregate_windowed")
    assert counts == {**{k: 0 for k in counts}, **{k: 1 for k in k1_k6}}
    # With H2 each piece counts once, the single non-H2 walks (the 8-path
    # final walk, the aggregate's walks) as sgm_walk; K3-K6 stay at 0.
    monkeypatch.setattr(sk, "_USE_H2", True)
    wass_tpu_torch.reset_launch_counts()
    sk.sgm_wta_fused(cost, 8, 96, 8, 1, 1)
    sk.sgm_wta_fused_windowed(wcost, ws, 8, 96, 5, 1)
    sk.sgm_aggregate(cost, 8, 96, 8)
    counts = wass_tpu_torch.launch_counts()
    assert counts == {**{k: 0 for k in counts}, "sgm_pair_img": 3, "sgm_tri_dir_partial_h2": 1,
                      "sgm_walk": 3, "sgm_tri_dir_wta_windowed_h2": 1}
    with pytest.raises(ValueError):
        sk.sgm_tri_dir_partial_h2(cost, cost[:, :, :4].contiguous(), cost, 8, 96, False)  # hf of another shape
    monkeypatch.setattr(sk, "_USE_H2", False)
    with pytest.raises(ValueError):
        sk.sgm_wta_fused(cost, 8, 96, 4, 1, 1)
    with pytest.raises(ValueError):
        sk.census_cost_volume(cb, cm.cpu(), 8, 1)
    with pytest.raises(ValueError):
        sk.census_cost_volume_windowed(cb, cm, ws.cpu(), 8)  # mixed devices
    with pytest.raises(ValueError):
        sk.sgm_wta_fused_windowed(wcost, ws.to(torch.int64), 8, 96, 5, 1)
    with pytest.raises(ValueError):
        sk.sgm_aggregate_windowed(wcost, ws, 8, 96, 4)
    with pytest.raises(ValueError):
        sk.sgm_aggregate_windowed(wcost[:12], ws, 8, 96, 2)  # H % 8 != 0


def _planted_clique(C, g, seed):
    """A symmetric (C, C) payoff: 0-0.05 noise with a g-clique of 0.9-1."""
    gen = torch.Generator().manual_seed(seed)
    A = torch.rand((C, C), generator=gen) * 0.05
    A[:g, :g] = 0.9 + 0.1 * torch.rand((g, g), generator=gen)
    A = (A + A.T) / 2
    A.fill_diagonal_(0.0)
    return A


# (C, clique size, seed).
IIDYN_CASES = [(40, 12, 0), (300, 30, 1), (2000, 60, 2), (4097, 50, 3)]


def _iidyn_equal(A, x0, mask, caps=(24, 4000), capped=True):
    """The kernel and the plain version (which adds in the kernel's order):
    the same update count, x and Nash error, capped at 24 updates and at up
    to 4000.  capped: the first run stops at its cap (it is below the
    run's convergence), so that the cap is exercised."""
    for cap in caps:
        xk, itk, ek = im.iidyn(A, x0, mask, max_iters=cap)
        xp, itp, ep = im.iidyn_plain(A, x0, mask, max_iters=cap)
        assert int(itk) == itp <= cap
        if capped and cap == caps[0]:
            assert itp == cap
        assert torch.equal(xk, xp) and torch.equal(ek, ep)
    if mask is not None:
        assert float(xk[~mask].abs().max()) == 0.0
    return itp


@pytest.mark.parametrize("C,g,seed", IIDYN_CASES)
@pytest.mark.parametrize("masked", [False, True])
def test_iidyn_kernel(dev, C, g, seed, masked):
    """Bit-equal to the plain version, capped (below any convergence here)
    and at up to 4000 updates (the unmasked C = 4097 case is still running
    at the cap)."""
    A = _planted_clique(C, g, seed).to(dev)
    gen = torch.Generator().manual_seed(seed + 100)
    mask = (torch.rand(C, generator=gen) > 0.25).to(dev) if masked else None
    x0 = im.initial_population(torch.rand(C, generator=gen).to(dev), mask)
    _iidyn_equal(A, x0, mask)


def _cluster_case(case, dev):
    """(A, mask) of the cluster's edges: CTAs that hold no live candidate
    (5 live: 11 of 16 CTAs); a run of ceil(C / GROUPS) columns with nothing
    live; one live candidate; C not a multiple of GROUPS x THREADS; the
    largest C the card's free memory takes for A (2000 live, so that the
    run converges: an update moves one candidate)."""
    C = {"not a multiple": 2 * im.GROUPS * im.THREADS + 13, "largest": None}.get(case, 3000)
    if C is None:
        free, _ = torch.cuda.mem_get_info(dev)
        C = int((0.4 * free / 4) ** 0.5)
    gen = torch.Generator(device=dev).manual_seed(C)
    A = torch.rand((C, C), generator=gen, device=dev) * 0.05
    n = min(C, 2000)
    A[:n, :n] = _planted_clique(n, 60, C).to(dev)
    mask = torch.zeros(C, dtype=torch.bool, device=dev)
    if case == "empty CTAs":
        mask[torch.randperm(C, generator=gen, device=dev)[:5]] = True
    elif case == "empty run":
        mask[:n] = torch.rand(n, generator=gen, device=dev) < 0.5
        R = -(-C // im.GROUPS)
        mask[R:2 * R] = False
    elif case == "one live":
        mask[1234] = True
    else:
        mask[:n] = True
    return A, mask, gen


@pytest.mark.parametrize("case", ["empty CTAs", "empty run", "one live", "not a multiple", "largest"])
def test_iidyn_kernel_cluster_edges(dev, case):
    A, mask, gen = _cluster_case(case, dev)
    x0 = im.initial_population(torch.rand(A.shape[0], generator=gen, device=dev), mask)
    # 5 live and one live converge within the first cap.
    its = _iidyn_equal(A, x0, mask, capped=case not in ("empty CTAs", "one live"))
    if case == "one live":
        assert its == 1


def test_iidyn_wrapper_counts_and_checks(dev):
    A = _planted_clique(64, 8, 5).to(dev)
    x0 = torch.full((64,), 1.0 / 64, device=dev)
    wass_tpu_torch.reset_launch_counts()
    im.iidyn(A, x0, max_iters=10)
    im.iidyn_plain(A, x0, max_iters=10)
    counts = wass_tpu_torch.launch_counts()
    assert counts == {**{k: 0 for k in counts}, "iidyn": 1}
    with pytest.raises(ValueError):
        im.iidyn(A.double(), x0.double())
    with pytest.raises(ValueError):
        im.iidyn(A[:, :32].contiguous(), x0)
    with pytest.raises(ValueError):
        im.iidyn(A, x0.cpu())  # mixed devices
    with pytest.raises(ValueError):
        im.iidyn(A, x0, torch.ones(64, dtype=torch.uint8, device=dev))


def _march_case(dev, B, H, W, seed, hole):
    """A slab of wave-like frames in cell units with the rays of a camera
    above one corner (visibility_device_batch's directions); with `hole`
    frame 0 has a NaN patch (its maxz is NaN)."""
    g = torch.Generator().manual_seed(seed)
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32), torch.arange(W, dtype=torch.float32), indexing="ij")
    Z = torch.stack([3 * torch.sin(0.3 * xx + 0.2 * yy + b) + torch.rand((H, W), generator=g) for b in range(B)])
    if hole:
        Z[0, H // 3:H // 3 + 3, W // 2:W // 2 + 4] = float("nan")
    Z, xx, yy = Z.to(dev), xx.to(dev), yy.to(dev)
    cam = torch.tensor([-0.3 * W, 1.4 * H, 12.0], device=dev)
    return Z, pg.ray_steps(pg.view_rays(Z, cam, xx, yy)), Z.amax(dim=(1, 2)), 2 * max(H, W)


@pytest.mark.parametrize("B,H,W,hole", [(8, 64, 64, False), (8, 64, 64, True), (3, 37, 101, True), (2, 129, 7, False),
                                        (1, 256, 256, True)])
def test_visibility_march_kernel(dev, B, H, W, hole):
    Z, d, maxz, steps = _march_case(dev, B, H, W, B * H + W, hole)
    occ = vk.march(Z, d, maxz, steps)
    assert torch.equal(occ, vk.march_plain(Z, d, maxz, steps))
    if hole:
        assert not occ[0].any()  # a NaN maxz stops every ray of frame 0 at its first step
    # The nanmax of each frame instead: the rays of frame 0 march too, and a
    # ray from a NaN cell still stops at once.
    finite = torch.where(torch.isnan(Z), torch.full_like(Z, -1e30), Z).amax(dim=(1, 2))
    occ = vk.march(Z, d, finite, steps)
    assert torch.equal(occ, vk.march_plain(Z, d, finite, steps))
    assert 0 < int(occ[0].sum()) < occ[0].numel()
    if hole:
        assert not occ[torch.isnan(Z)].any()


def test_visibility_march_wrapper_counts_and_checks(dev):
    Z, d, maxz, steps = _march_case(dev, 2, 16, 24, 0, False)
    wass_tpu_torch.reset_launch_counts()
    vk.march(Z, d, maxz, steps)
    vk.march_plain(Z, d, maxz, steps)
    counts = wass_tpu_torch.launch_counts()
    assert counts == {**{k: 0 for k in counts}, "visibility_march": 1}
    with pytest.raises(ValueError):
        vk.march(Z.double(), d.double(), maxz.double(), steps)
    with pytest.raises(ValueError):
        vk.march(Z, d[:-1], maxz, steps)
    with pytest.raises(ValueError):
        vk.march(Z, d.cpu(), maxz, steps)  # mixed devices
