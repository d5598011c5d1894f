"""The CUDA kernels against their plain versions on the card (the JPEG
kernel also against OpenCV's encoder).

Marked `cuda`: they need an NVIDIA GPU and nvcc and skip without them.
Run them on the GPU machine, which has no jax for the shared conftest, with
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py -q
(chip_smoke.py checks the same kernels at the full 3 MP shapes)."""

import io
import threading

import numpy as np
import pytest
import torch

import wass_tpu_torch
from wass_tpu_torch.cli.main import load_pipeline
from wass_tpu_torch.cli.pipeline import SequencePipeline
from wass_tpu_torch.io import jpeg
from wass_tpu_torch.io.image import encode_jpeg
from wass_tpu_torch.match import iidyn as im
from wass_tpu_torch.ops import components_kernels as ck
from wass_tpu_torch.post import geometry as pg
from wass_tpu_torch.post import visibility_kernels as vk
from wass_tpu_torch.stereo import flow as tflow
from wass_tpu_torch.stereo import flow_kernels as fk
from wass_tpu_torch.stereo import sgm_kernels as sk
from wass_tpu_torch.stereo import sgm as plain_sgm
from wass_tpu_torch.stereo.cost import census_cost_volume, census_cost_volume_windowed, census_transform
from wass_tpu_torch.stereo.sgm import sgm_wta_fused_plain
from wass_tpu_torch.testing import write_pairs
from wass_tpu_torch.testing.synthetic import make_rig, make_scene
from wass_tpu_torch.utils import render

from torch_jpeg_cases import CASES, FRAME_SHAPES, case_id, case_image, image

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


def _census_input(kind, h, w, seed):
    """rand: uniform grey levels; ties: integer levels (0-255 in steps of
    51), a run of 255 and the rectifier's zero borders; ulps: neighbours a
    few float32 ulps apart, where any other order of the blur's products
    and sums flips census bits; specials: -0, +-inf, NaN of both signs and
    subnormals among small integers."""
    g = torch.Generator().manual_seed(seed)
    if kind == "rand":
        return torch.rand((h, w), generator=g) * 255
    if kind == "ulps":
        return 100.0 + torch.rand((h, w), generator=g) * 2e-4
    if kind == "specials":
        x = torch.randint(0, 4, (h, w), generator=g).float()
        pick = torch.randint(0, 8, (h, w), generator=g)
        for i, v in enumerate((-0.0, 0.0, float("inf"), -float("inf"), 1e-40, -1e-40, float("nan"), -float("nan"))):
            x[(pick == i) & (torch.rand((h, w), generator=g) < 0.3)] = v
        return x
    x = torch.randint(0, 6, (h, w), generator=g).float() * 51
    x[:, : w // 5] = 255.0
    x[: h // 6] = 0.0
    x[:, -3:] = 0.0
    return x


# (H, W, window, sigma, input): the main path's full-resolution (sigma 0.8)
# and coarse (384x512, unsmoothed) images; AUTO (-1); sigma 1.7 (11 taps)
# and 2.0 (13 taps), pairwise trees with a leftover; sigma 3.0 (radius 9,
# past the unrolled radii); 1-3 and 8 words; odd shapes, W not a multiple
# of 4 (no vector stores), images smaller than the window; special values.
CENSUS_TRANSFORM_CASES = [
    (1536, 2048, (7, 9), 0.8, "rand"), (1536, 2048, (7, 9), 0.8, "ulps"), (1536, 2048, (7, 9), -1.0, "ties"),
    (384, 512, (7, 9), 0.0, "rand"), (384, 512, (7, 9), 0.0, "ties"), (200, 300, (7, 9), 1.7, "ulps"),
    (200, 300, (7, 9), 2.0, "ulps"), (200, 300, (7, 9), 3.0, "ulps"), (37, 53, (5, 5), 0.8, "ulps"),
    (37, 53, (9, 9), 0.8, "ties"), (37, 53, (9, 9), 0.0, "rand"), (37, 53, (5, 5), 1.7, "ties"),
    (66, 67, (7, 9), -1.0, "ulps"), (97, 131, (15, 17), 0.8, "ulps"), (5, 4, (7, 9), 0.8, "rand"),
    (3, 3, (9, 9), 0.0, "ties"), (37, 53, (7, 9), 0.0, "specials"), (64, 68, (7, 9), 0.8, "specials"),
    (37, 53, (5, 5), 0.8, "specials"),
]


@pytest.mark.parametrize("h,w,win,sigma,kind", CENSUS_TRANSFORM_CASES)
def test_census_transform_kernel(dev, h, w, win, sigma, kind):
    img = _census_input(kind, h, w, h * w).to(dev)
    assert torch.equal(sk.census_transform(img, win, sigma), census_transform(img, win, sigma))


def test_census_transform_counts_and_checks(dev):
    img = _census_input("rand", 40, 64, 1).to(dev)
    wass_tpu_torch.reset_launch_counts()
    sk.census_transform(img, (7, 9), 0.8)
    sk.census_transform(img, (5, 5), 0.0)
    counts = wass_tpu_torch.launch_counts()
    assert counts == {**{k: 0 for k in counts}, "census": 2}
    assert sk.census_transform(img[:0], (7, 9), 0.8).shape == (0, 64, 2)  # nothing to launch
    assert wass_tpu_torch.launch_counts()["census"] == 2
    taps = dict(sk._BLUR_TAPS)
    sk.census_transform(img, (7, 9), -1.0)  # AUTO: the taps of 0.8 (radius 2), made once
    assert sk._BLUR_TAPS.keys() == taps.keys() and (0.8, 2, img.device) in taps
    for bad in ((img, (6, 9)), (img, (17, 17)), (img.double(), (7, 9)), (img.t(), (7, 9)), (img[None], (7, 9))):
        with pytest.raises(ValueError):
            sk.census_transform(*bad, 0.8)


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


# The fused visibility kernel's cases: _march_case's shapes, the command's
# (count, X, Y) layout (every incidence NaN), a grazing camera (long
# marches) and a camera inside the grid's footprint (rays in every
# direction, some near vertical).  (B, H, W, hole, layout, cam)
VISIBILITY_CASES = [(8, 64, 64, False, "xy", None), (8, 64, 64, True, "xy", None), (3, 37, 101, True, "xy", None),
                    (2, 129, 7, False, "xy", None), (1, 256, 256, True, "xy", None), (3, 48, 80, True, "cube", None),
                    (3, 64, 96, False, "xy", (-200.0, 30.0, 4.0)), (3, 64, 96, True, "xy", (40.0, 30.0, 6.0))]


def _visibility_case(dev, B, H, W, hole, layout, cam):
    g = torch.Generator().manual_seed(B * H + W)
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32), torch.arange(W, dtype=torch.float32), indexing="ij")
    Z = torch.stack([3 * torch.sin(0.3 * xx + 0.2 * yy + b) + torch.rand((H, W), generator=g) for b in range(B)])
    if hole:
        Z[0, H // 3:H // 3 + 3, W // 2:W // 2 + 4] = float("nan")
    if layout == "cube":
        xx, yy = yy, xx
    cam = torch.tensor(cam or (-0.3 * W, 1.4 * H, 12.0))
    return [t.contiguous().to(dev) for t in (Z, cam, xx, yy)], 2 * max(H, W)


def _same_bits(a, b):
    """Equal bit for bit, NaN at the same cells."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32))


@pytest.mark.parametrize("case", VISIBILITY_CASES)
def test_visibility_batch_kernel(dev, case):
    (Z, cam, XX, YY), steps = _visibility_case(dev, *case)
    occ, inc = vk.visibility_batch(Z, cam, XX, YY, steps)
    occ_p, inc_p = vk.visibility_batch_plain(Z, cam, XX, YY, steps)
    assert occ.dtype == torch.bool and torch.equal(occ, occ_p)
    assert _same_bits(inc, inc_p)
    if case[4] == "cube":
        assert torch.isnan(inc).all()
    if case[3]:
        assert torch.equal(occ[0], inc[0] >= 88)  # frame 0's max is NaN: only grazing cells


@pytest.mark.parametrize("case", VISIBILITY_CASES)
def test_visibility_march_kernel_refills(dev, case):
    """The march-only kernel (the same refilling loop) on the fused
    kernel's cases, with each frame's max and its nanmax."""
    (Z, cam, XX, YY), steps = _visibility_case(dev, *case)
    d = pg.ray_steps(pg.view_rays(Z, cam, XX, YY))
    for maxz in (Z.amax(dim=(1, 2)), torch.where(torch.isnan(Z), torch.full_like(Z, -1e30), Z).amax(dim=(1, 2))):
        assert torch.equal(vk.march(Z, d, maxz, steps), vk.march_plain(Z, d, maxz, steps))


def test_visibility_batch_wrapper_counts_and_checks(dev):
    (Z, cam, XX, YY), steps = _visibility_case(dev, 2, 16, 24, False, "xy", None)
    wass_tpu_torch.reset_launch_counts()
    vk.visibility_batch(Z, cam, XX, YY, steps)
    vk.visibility_batch_plain(Z, cam, XX, YY, steps)
    counts = wass_tpu_torch.launch_counts()
    assert counts == {**{k: 0 for k in counts}, "visibility_batch": 1}
    for args in [(Z.double(), cam, XX, YY), (Z, cam[:2], XX, YY), (Z, cam, XX[:-1], YY),
                 (Z.transpose(1, 2).contiguous().transpose(1, 2), cam, XX, YY), (Z, cam.cpu(), XX, YY)]:
        with pytest.raises(ValueError):
            vk.visibility_batch(*args, steps)


def test_outlier_votes_are_reproducible_on_the_card(dev):
    """The card's votes sum each cell's moments in a fixed order: two runs
    give the same votes and the same sums; the CPU's index_add_ order gives
    votes that differ at most at a few points near the threshold."""
    from wass_tpu_torch.grid import outliers

    rng = np.random.default_rng(3)
    n = 400000
    x, y = rng.uniform(-8, 8, n), rng.uniform(-8, 8, n)
    z = 0.05 * x - 0.03 * y + 0.05 * rng.standard_normal(n)
    z[rng.choice(n, 2000, replace=False)] += rng.uniform(-3, 3, 2000)
    pts = torch.as_tensor(np.stack([x, y, z], 1), dtype=torch.float32)
    keep = [outliers._vote_device(pts.to(dev), 0.2) for _ in range(3)]
    assert torch.equal(keep[0], keep[1]) and torch.equal(keep[0], keep[2])
    cell = torch.as_tensor(rng.integers(0, 225, n), device=dev)
    v = pts.to(dev)
    assert torch.equal(outliers.segment_sums(v, outliers.segment_plan(cell, 225)),
                       outliers.segment_sums(v, outliers.segment_plan(cell, 225)))
    assert (keep[0].cpu() != outliers._vote_device(pts, 0.2)).double().mean() <= 1e-3


@pytest.mark.parametrize("max_steps", [0, 1, 3, 5, 7])
def test_visibility_kernels_cut_marches(dev, max_steps):
    """max_steps cuts the rays between the steps a lane takes together."""
    (Z, cam, XX, YY), _ = _visibility_case(dev, 3, 64, 96, True, "xy", (-200.0, 30.0, 4.0))
    occ, inc = vk.visibility_batch(Z, cam, XX, YY, max_steps)
    occ_p, inc_p = vk.visibility_batch_plain(Z, cam, XX, YY, max_steps)
    assert torch.equal(occ, occ_p) and _same_bits(inc, inc_p)
    d, maxz = pg.ray_steps(pg.view_rays(Z, cam, XX, YY)), Z.amax(dim=(1, 2))
    assert torch.equal(vk.march(Z, d, maxz, max_steps), vk.march_plain(Z, d, maxz, max_steps))


# The flow kernels' shapes: ragged, one-pixel and three-pixel images (no
# pixel inside the one-pixel border), and warps of each scale: small ones
# that stay inside the image, large ones that leave it, some on integer
# taps, a NaN and an infinite one.
FLOW_SHAPES = [(777, 1001), (1, 5), (3, 3), (2, 40), (33, 1), (64, 96)]


def _flow_case(dev, h, w, scale, seed):
    g = torch.Generator().manual_seed(seed)
    I0, I1 = (torch.rand((h, w), generator=g) * 255 for _ in range(2))
    u, v = (torch.randn((h, w), generator=g) * scale for _ in range(2))
    u.view(-1)[::7] = torch.round(u.view(-1)[::7])
    if h * w > 4:
        u.view(-1)[1] = float("nan")
        v.view(-1)[2] = float("inf")
    gx, gy = tflow._image_grads(I1)
    return [t.to(dev).contiguous() for t in (I0, I1, gx, gy, u, v)]


def _same_fields(a, b):
    return all(torch.equal(x.nan_to_num(7.0), y.nan_to_num(7.0)) and torch.equal(x.isnan(), y.isnan())
               for x, y in zip(a, b))


@pytest.mark.parametrize("h,w", FLOW_SHAPES)
@pytest.mark.parametrize("scale", [0.3, 3.0, 60.0])
def test_flow_linearize_kernel(dev, h, w, scale):
    args = _flow_case(dev, h, w, scale, h * w)
    before = wass_tpu_torch.launch_counts()["flow_linearize"]
    out = fk.flow_linearize(*args)
    assert wass_tpu_torch.launch_counts()["flow_linearize"] == before + 1
    assert _same_fields(out, fk.flow_linearize_plain(*args))


@pytest.mark.parametrize("h,w", FLOW_SHAPES)
@pytest.mark.parametrize("scale", [0.3, 60.0])
def test_flow_jacobi_kernel(dev, h, w, scale):
    I0, I1, gx, gy, u, v = _flow_case(dev, h, w, scale, h + w)
    u0, v0 = u.nan_to_num(0.0, 0.0, 0.0), v.nan_to_num(0.0, 0.0, 0.0)
    It, Ix, Iy, wdata = fk.flow_linearize_plain(I0, I1, gx, gy, u0, v0)
    g = torch.Generator().manual_seed(h * w + 1)
    un, vn = (torch.randn((h, w), generator=g).to(dev) for _ in range(2))
    lam = tflow.smoothness_ratio(300.0, 100.0)
    out = fk.flow_jacobi(un, vn, u0, v0, It, Ix, Iy, wdata, lam)
    assert _same_fields(out, fk.flow_jacobi_plain(un, vn, u0, v0, It, Ix, Iy, wdata, lam))


@pytest.mark.parametrize("outer,inner", [(2, 5), (3, 5), (3, 4)])
def test_flow_solver_kernels_match_plain_loop(dev, outer, inner):
    """A solve through the kernels (the three rotating buffers included:
    odd and even sweep counts, every buffer a warp point once) against the
    plain versions' loop on the card."""
    I0, I1, gx, gy, u, v = _flow_case(dev, 97, 131, 0.5, 5)
    flow = torch.stack([u.nan_to_num(0.0, 0.0, 0.0), v.nan_to_num(0.0, 0.0, 0.0)], -1)
    kept = flow.clone()
    got = tflow.variational_refine(I0, I1, flow, 300.0, 100.0, outer, inner)
    assert torch.equal(flow, kept)
    lam = tflow.smoothness_ratio(300.0, 100.0)
    pu, pv = flow[..., 0].contiguous(), flow[..., 1].contiguous()
    for _ in range(outer):
        u0, v0 = pu, pv
        It, Ix, Iy, wdata = fk.flow_linearize_plain(I0, I1, gx, gy, u0, v0)
        for _ in range(inner):
            pu, pv = fk.flow_jacobi_plain(pu, pv, u0, v0, It, Ix, Iy, wdata, lam)
    assert torch.equal(got, torch.stack([pu, pv], -1))


def test_flow_jacobi_refuses_aliased_output(dev):
    args = _flow_case(dev, 8, 9, 0.5, 1)
    u0, v0 = args[4], args[5]
    It, Ix, Iy, wdata = fk.flow_linearize(*args)
    with pytest.raises(ValueError):
        fk.flow_jacobi(u0, v0, u0, v0, It, Ix, Iy, wdata, 3.0, out=(u0, torch.empty_like(u0)))


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_jpeg_kernel(dev, case):
    """The kernel's file equals the plain version's and OpenCV's."""
    img, quality = case_image(case)
    want = encode_jpeg(img, quality)
    assert jpeg.encode_plain(img, quality) == want
    assert jpeg.encode([torch.from_numpy(img).to(dev)], quality) == [want]


@pytest.mark.parametrize("shape", FRAME_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kind", ["smooth", "noise"])
def test_jpeg_kernel_frame_shapes(dev, shape, kind):
    """A 5 MP frame's render shapes, smooth and noise (the longest streams)."""
    img = image(kind, shape, sum(shape))
    want = encode_jpeg(img, 75)
    assert jpeg.encode_plain(img, 75) == want
    assert jpeg.encode([torch.from_numpy(img).to(dev)], 75) == [want]


@pytest.mark.parametrize("shape", [(48, 64, 3), (40, 48)], ids=["rgb", "grey"])
def test_jpeg_kernel_unaligned_rows(dev, shape):
    """An image one byte into its buffer (rows on no alignment) encodes to
    OpenCV's file."""
    img = image("noise", shape, 7)
    t = torch.empty(img.size + 1, dtype=torch.uint8, device=dev)[1:].view(shape)
    t.copy_(torch.from_numpy(img))
    assert t.is_contiguous() and t.data_ptr() % 8 != 0
    assert jpeg.encode([t], 75) == [encode_jpeg(img, 75)]


def test_jpeg_kernel_eight_images_a_call(dev):
    """Eight images of mixed shapes and kinds in one call, each file
    OpenCV's; an encoder's buffers serve call after call."""
    imgs = [case_image(c)[0] for c in CASES if c[2] == 90][::10][:8]
    assert len(imgs) == jpeg.MAX_IMAGES and {i.ndim for i in imgs} == {2, 3}
    tensors = [torch.from_numpy(i).to(dev) for i in imgs]
    want = [encode_jpeg(i, 90) for i in imgs]
    cache = {}
    enc = jpeg.device_encoder(cache, tensors, 90)
    for _ in range(3):
        assert enc.fetch(enc.run(tensors)) == want
    assert jpeg.device_encoder(cache, tensors, 90) is enc and len(cache) == 1


def test_jpeg_wrapper_dispatch_counts_and_checks(dev):
    img = torch.from_numpy(image("smooth", (37, 61, 3), 4))
    wass_tpu_torch.reset_launch_counts()
    assert jpeg.encode([img], 75) == [encode_jpeg(img.numpy(), 75)]
    assert wass_tpu_torch.launch_counts()["jpeg"] == 0
    assert jpeg.encode([img.to(dev)], 75) == [encode_jpeg(img.numpy(), 75)]
    counts = wass_tpu_torch.launch_counts()
    assert counts == {**{k: 0 for k in counts}, "jpeg": jpeg.KERNELS_A_CALL}
    with pytest.raises(ValueError, match="1-8 images"):
        jpeg.encode([img.to(dev)] * (jpeg.MAX_IMAGES + 1), 75)
    with pytest.raises(ValueError):
        jpeg.encode([img.to(dev), img], 75)  # mixed devices
    with pytest.raises(ValueError, match="uint8"):
        jpeg.encode([img.to(dev, torch.float32)], 75)
    with pytest.raises(ValueError, match="contiguous"):
        jpeg.encode([img.to(dev)[:, ::2]], 75)
    with pytest.raises(ValueError, match="RGB"):
        jpeg.encode([torch.zeros((8, 8, 4), dtype=torch.uint8, device=dev)], 75)
    assert wass_tpu_torch.launch_counts()["jpeg"] == jpeg.KERNELS_A_CALL


def test_loop_jpegs_on_the_card_equal_the_cpu_loop(dev, tmp_path, monkeypatch):
    """Two 256x192 frames through the CLI's loop (renders on, two writers)
    on the card and on the CPU.  The card encodes each frame's six renders
    (render_device_images 6, four launches a frame, render_bytes the JPEG
    streams) and every file is OpenCV's encoding of the image its writer
    built.  Where the two loops build the same image (the stacked input
    pair always; a render of the disparity only where the card's float
    disparity equals the CPU's to the bit), the files are the same bytes."""
    W, H = 256, 192
    rig = make_rig(width=W, height=H)
    scenes = [make_scene(seed=3, width=W, height=H, wave_amplitude=0.25, rig=rig, time=k / 15.0) for k in range(2)]
    pairs = [tuple(np.clip(img, 0, 255).astype(np.uint8) for img in (s.img0, s.img1)) for s in scenes]
    local, kept, run = threading.local(), {}, {}
    write, build = SequencePipeline._write_renders, render.stereo_renders

    def write_kept(wd, geom, res, extras):
        local.name = wd.path.name
        return write(wd, geom, res, extras)

    def build_kept(*args, **kwargs):
        images = build(*args, **kwargs)
        kept[run["device"], local.name] = {name: render.fetch(img).copy() for name, img in images.items()}
        return images

    monkeypatch.setattr(SequencePipeline, "_write_renders", staticmethod(write_kept))
    monkeypatch.setattr(render, "stereo_renders", build_kept)
    files, stats = {}, {}
    for device in ("cuda", "cpu"):
        run["device"] = device
        seq = tmp_path / device
        wds = write_pairs(seq, pairs, rig)
        (seq / "stereo_config.txt").write_text("MAX_DISPARITY=160\n")
        wass_tpu_torch.reset_launch_counts()
        pipe = load_pipeline(seq, device)
        assert pipe.cfg.debug_renders and pipe.cfg.writer_threads == 2
        pipe.stereo(progress_stream=io.StringIO())
        stats[device] = pipe.loop_stats
        assert wass_tpu_torch.launch_counts()["jpeg"] == (2 * jpeg.KERNELS_A_CALL if device == "cuda" else 0)
        files[device] = {(wd.name, p.name): p.read_bytes() for wd in wds for p in sorted(wd.glob("*.jpg"))}
        assert len(files[device]) == 12
        for (name, fname), data in files[device].items():
            assert data == encode_jpeg(kept[device, name][fname]), (device, name, fname)
    same = [key for key in files["cuda"] if np.array_equal(kept[("cuda", key[0])][key[1]], kept[("cpu", key[0])][key[1]])]
    assert {("000000_wd", "stereo_input.jpg"), ("000001_wd", "stereo_input.jpg")} <= set(same)
    assert all(files["cuda"][key] == files["cpu"][key] for key in same)
    assert stats["cuda"]["render_device_images"] == [6.0, 6.0] and stats["cpu"]["render_device_images"] == [0.0, 0.0]
    streams = [sum(len(data) - len(jpeg.header(*jpeg._shape(kept[("cuda", n)][f].shape), 75)) - len(jpeg.EOI)
                   for (n, f), data in files["cuda"].items() if n == wd) for wd in ("000000_wd", "000001_wd")]
    assert stats["cuda"]["render_bytes"] == [float(b) for b in streams]
    assert stats["cpu"]["render_bytes"] == [20.0 * W * H] * 2
