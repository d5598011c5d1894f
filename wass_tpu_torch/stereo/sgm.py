"""Plain semi-global matching: path aggregation and winner-take-all.

Counterpart of wass_tpu/stereo/sgm.py.  Along a path r,

    L_r(p, d) = C(p, d) + min( L_r(p-r, d),
                               L_r(p-r, d-1) + P1,
                               L_r(p-r, d+1) + P1,
                               min_k L_r(p-r, k) + P2 ) - min_k L_r(p-r, k)

and the first pixel of a path has L = C.  Every L is a small integer
(C <= 64 and L <= C + P2 < 256), so the int16 sum over paths is exact in
any order.  These functions are the CPU path and the oracles of the SGM
kernels (stereo/sgm_kernels.py, csrc/sgm.cu):

  K3 sgm_wta_fused_plain            K4 sgm_wta_fused_windowed_plain
  K5 sgm_aggregate                  K6 sgm_aggregate_windowed
  H2 run_pair_img_plain, run_tri_dir_{partial,wta}_h2_plain,
     run_tri_dir_{partial,wta}_windowed_h2_plain, and the single walks of
     the H2 compositions (walk_add, run_tri_dir_wta{,_windowed}_plain)

A windowed volume (H, W, Dw) holds at lane j of row y the disparity
wstart[y // TILE_ROWS] + j (stereo/c2f.py).  Walks along a row keep one
window; a walk that crosses into a row tile with another window start
realigns its carry first: new lane j takes old lane j + delta, delta the
change of window start, and lanes with no source get 255 (the
no-predecessor value of wass_tpu/stereo/sgm_pallas.py:_windowed_realign).
"""

from __future__ import annotations

from typing import Tuple

import torch

from wass_tpu_torch.stereo.cost import TILE_ROWS

_BIG = 32000
_REALIGN_FILL = 255  # carry of a lane that leaves the window (see above)
_WTA_ROWS = 64  # rows per WTA block: (64, W, D) int32 temporaries

# Path directions (dy, dx) walked by each path set: the step from p - r to p.
# 5 is the cv::StereoSGBM default set (E, W, N, NW, NE: the horizontal pair
# and the top-down walks), 8 the full set.
DIRECTIONS = {
    2: ((0, 1), (0, -1)),
    4: ((0, 1), (0, -1), (1, 0), (-1, 0)),
    5: ((0, 1), (0, -1), (1, 0), (1, 1), (1, -1)),
    8: ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1), (-1, -1)),
}


def _check_p2(P2: int) -> None:
    if not 64 + P2 < 256:
        raise ValueError(f"P2={P2} too large: per-path costs must stay below 256")


def _sgm_step(prev: torch.Tensor, cost: torch.Tensor, P1: int, P2: int) -> torch.Tensor:
    """One SGM update on (..., D) int32 slabs."""
    minprev = prev.amin(-1, keepdim=True)
    big = torch.full_like(prev[..., :1], _BIG)
    up = torch.cat([big, prev[..., :-1]], -1)
    dn = torch.cat([prev[..., 1:], big], -1)
    best = torch.minimum(torch.minimum(prev, minprev + P2), torch.minimum(up, dn) + P1)
    return cost + best - minprev


def _realign(L: torch.Tensor, delta: int) -> torch.Tensor:
    """Carry of a walk entering a row tile whose window starts delta
    disparities later: lane j <- lane j + delta, 255 where that is outside."""
    D = L.shape[-1]
    out = torch.full_like(L, _REALIGN_FILL)
    if abs(delta) < D:
        if delta >= 0:
            out[:, : D - delta] = L[:, delta:]
        else:
            out[:, -delta:] = L[:, : D + delta]
    return out


def _walk(c: torch.Tensor, agg: torch.Tensor, dy: int, dx: int, P1: int, P2: int, wstart=None) -> None:
    """Add the path costs of direction (dy, dx) to agg (in place); wstart
    (a list of per-tile window starts) realigns the carry between row
    tiles of a windowed volume."""
    H, W, D = c.shape
    if dy == 0:
        order = range(W) if dx > 0 else range(W - 1, -1, -1)
        L = torch.full((H, D), _BIG, dtype=torch.int32, device=c.device)
        for x in order:
            L = _sgm_step(L, c[:, x].to(torch.int32), P1, P2)
            agg[:, x] += L.to(agg.dtype)
        return
    order = range(H) if dy > 0 else range(H - 1, -1, -1)
    L = torch.full((W, D), _BIG, dtype=torch.int32, device=c.device)
    big = torch.full((1, D), _BIG, dtype=torch.int32, device=c.device)
    for y in order:
        if wstart is not None and y != order[0]:
            t, tp = y // TILE_ROWS, (y - dy) // TILE_ROWS
            if wstart[t] != wstart[tp]:  # before the diagonal's entry reset
                L = _realign(L, wstart[t] - wstart[tp])
        if dx > 0:  # the carry at x comes from x - 1 of the previous row
            L = torch.cat([big, L[:-1]], 0)
        elif dx < 0:
            L = torch.cat([L[1:], big], 0)
        L = _sgm_step(L, c[y].to(torch.int32), P1, P2)
        agg[y] += L.to(agg.dtype)


def _aggregate(cost: torch.Tensor, P1: int, P2: int, directions: int, wstart=None) -> torch.Tensor:
    _check_p2(P2)
    agg = torch.zeros(cost.shape, dtype=torch.int16, device=cost.device)
    for dy, dx in DIRECTIONS[directions]:
        _walk(cost, agg, dy, dx, P1, P2, wstart)
    return agg


def sgm_aggregate(cost: torch.Tensor, P1: int, P2: int, directions: int = 8) -> torch.Tensor:
    """Plain form of kernel K5: (H, W, D) uint8 cost -> (H, W, D) int16
    sum over the path set `directions` (2, 4, 5 or 8)."""
    if directions not in DIRECTIONS:
        raise ValueError(f"directions must be one of {sorted(DIRECTIONS)}, got {directions}")
    return _aggregate(cost, P1, P2, directions)


def _window_starts(wstart_tiles: torch.Tensor, H: int) -> list:
    if wstart_tiles.shape != (H // TILE_ROWS,) or H % TILE_ROWS:
        raise ValueError(f"a windowed volume needs H % {TILE_ROWS} == 0 and ({H // TILE_ROWS},) window starts, "
                         f"got H={H} and {tuple(wstart_tiles.shape)}")
    return [int(v) for v in wstart_tiles.tolist()]


def sgm_aggregate_windowed(
    cost: torch.Tensor, wstart_tiles: torch.Tensor, P1: int, P2: int, directions: int = 8
) -> torch.Tensor:
    """Plain form of kernel K6: sgm_aggregate over a windowed (H, W, Dw)
    volume with per-tile window starts wstart_tiles (H // 8,), for the
    path sets 2, 5 and 8 (those of sgm_aggregate_pallas_windowed)."""
    if directions not in (2, 5, 8):
        raise ValueError(f"the windowed aggregation takes 2, 5 or 8 directions, got {directions}")
    return _aggregate(cost, P1, P2, directions, _window_starts(wstart_tiles, cost.shape[0]))


def _wta_rows(a: torch.Tensor, min_disp: int, uniqueness_ratio: int):
    """WTA on a block of rows: a (h, W, D) int32 -> (disp, best, valid)."""
    D = a.shape[-1]
    didx = torch.arange(D, dtype=torch.int64, device=a.device)
    dmin = a.amin(-1)
    best = torch.where(a == dmin[..., None], didx, D).amin(-1)
    big = 1 << 30
    sm1 = torch.where(didx == best[..., None] - 1, a, big).amin(-1)
    sp1 = torch.where(didx == best[..., None] + 1, a, big).amin(-1)
    far_min = torch.where((didx - best[..., None]).abs() > 1, a, big).amin(-1)
    thresh = torch.div(dmin * (100 + uniqueness_ratio), 100, rounding_mode="floor")
    valid = far_min > thresh
    interior = (best > 0) & (best < D - 1)
    sm1s = torch.where(interior, sm1, dmin)
    sp1s = torch.where(interior, sp1, dmin)
    denom = torch.clamp_min(sm1s + sp1s - 2 * dmin, 1)
    delta = ((sm1s - sp1s).to(torch.float32) / (2.0 * denom.to(torch.float32))).clamp(-0.5, 0.5)
    disp = (best + min_disp).to(torch.float32) + torch.where(interior, delta, 0.0)
    return disp, best, valid


def wta_disparity(
    agg: torch.Tensor,
    min_disp: int,
    uniqueness_ratio: int = 1,
    lr_max_diff: int = -1,
) -> torch.Tensor:
    """Winner-take-all + parabola subpixel + uniqueness + optional
    left-right check; (H, W) float32 disparity, 0 = invalid.  Rows are
    processed in blocks to bound the int32 temporaries."""
    H, W, D = agg.shape
    disp = torch.empty((H, W), dtype=torch.float32, device=agg.device)
    best = torch.empty((H, W), dtype=torch.int64, device=agg.device)
    valid = torch.empty((H, W), dtype=torch.bool, device=agg.device)
    for y0 in range(0, H, _WTA_ROWS):
        y1 = min(H, y0 + _WTA_ROWS)
        disp[y0:y1], best[y0:y1], valid[y0:y1] = _wta_rows(
            agg[y0:y1].to(torch.int32), min_disp, uniqueness_ratio
        )
    if lr_max_diff >= 0:
        # Left-base disparity from the same volume:
        # dispL(y, xl) = argmin_d agg(y, xl + d, d), a running-min fold.
        xs = torch.arange(W, device=agg.device)
        bc = torch.zeros((H, W), dtype=torch.int64, device=agg.device)
        bv = torch.full((H, W), _BIG, dtype=agg.dtype, device=agg.device)
        for j in range(D):
            v = agg[:, (xs + j + min_disp) % W, j]
            better = v < bv
            bc = torch.where(better, j, bc)
            bv = torch.minimum(v, bv)
        best_l = bc + min_disp
        xl = torch.clamp(xs[None, :] - (best + min_disp), 0, W - 1)
        d_l = torch.gather(best_l, 1, xl)
        valid = valid & ((best + min_disp - d_l).abs() <= lr_max_diff)
    return torch.where(valid, disp, 0.0)


def sgm_wta_fused_plain(
    cost: torch.Tensor,
    P1: int,
    P2: int,
    directions: int,
    min_disp: int,
    uniqueness_ratio: int = 1,
) -> torch.Tensor:
    """Plain form of kernel K3: wta_disparity(sgm_aggregate(...)) for the
    5- and 8-path sets, no left-right check."""
    if directions not in (5, 8):
        raise ValueError(f"the fused path takes 5 or 8 directions, got {directions}")
    return wta_disparity(sgm_aggregate(cost, P1, P2, directions), min_disp, uniqueness_ratio)


def wta_disparity_windowed(agg: torch.Tensor, off_rows: torch.Tensor, uniqueness_ratio: int = 1) -> torch.Tensor:
    """WTA over a windowed volume (lane j of row y is disparity
    off_rows[y] + j): the standard WTA with the min_disp = 1 sentinel, so
    that 0 stays the invalid marker, then the per-row shift, in the
    reference's float order (d - 1) + off."""
    d = wta_disparity(agg, 1, uniqueness_ratio)
    return torch.where(d == 0.0, 0.0, (d - 1.0) + off_rows[:, None].to(torch.float32))


def sgm_wta_fused_windowed_plain(
    cost: torch.Tensor,
    wstart_tiles: torch.Tensor,
    P1: int,
    P2: int,
    directions: int,
    uniqueness_ratio: int = 1,
) -> torch.Tensor:
    """Plain form of kernel K4: the windowed 5- or 8-path sum and its WTA,
    as the (H, W) float32 disparity in true units (0 = invalid)."""
    if directions not in (5, 8):
        raise ValueError(f"the fused path takes 5 or 8 directions, got {directions}")
    agg = sgm_aggregate_windowed(cost, wstart_tiles, P1, P2, directions)
    return wta_disparity_windowed(agg, wstart_tiles.repeat_interleave(TILE_ROWS), uniqueness_ratio)


# H2: the pieces of the JAX package's _USE_H2 compositions
# (wass_tpu/stereo/sgm_pallas.py).  The horizontal pair runs in image
# layout and leaves two uint8 volumes hf, hb; a row walk starts from
# hf + hb instead of an int16 horizontal sum.  Walks are the row walks of
# _run_tri_dir: forward (reverse=False) top-down through N, NW, NE, backward
# bottom-up; "vert" is the slab-axis _run_pair of the 4-path set.  The walks
# add into the int16 volume they are given, in place; windowed volumes
# (wstart_tiles) realign the carries only, never hf and hb.
WALKS = {
    "fwd": ((1, 0), (1, 1), (1, -1)),
    "bwd": ((-1, 0), (-1, -1), (-1, 1)),
    "vert": ((1, 0), (-1, 0)),
}


def run_pair_img_plain(cost: torch.Tensor, P1: int, P2: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain form of _run_pair_img: (H, W, D) uint8 -> (hf, hb) uint8, the
    left-to-right and right-to-left path costs, both at their true
    positions (L < 64 + P2 < 256 fits a byte)."""
    _check_p2(P2)
    hf, hb = torch.zeros_like(cost), torch.zeros_like(cost)
    _walk(cost, hf, 0, 1, P1, P2)
    _walk(cost, hb, 0, -1, P1, P2)
    return hf, hb


def walk_add(cost: torch.Tensor, acc: torch.Tensor, walk: str, P1: int, P2: int, wstart_tiles=None) -> torch.Tensor:
    """Add the path costs of `walk` (a key of WALKS) to the int16 volume acc
    in place and return it: acc + _run_tri_dir(...) (or
    _run_tri_dir_windowed with window starts, or the slab-axis _run_pair)."""
    _check_p2(P2)
    ws = None if wstart_tiles is None else _window_starts(wstart_tiles, cost.shape[0])
    for dy, dx in WALKS[walk]:
        _walk(cost, acc, dy, dx, P1, P2, ws)
    return acc


def _h2_sum(hf: torch.Tensor, hb: torch.Tensor) -> torch.Tensor:
    acc = hf.to(torch.int16)
    acc += hb
    return acc


def _tri(reverse: bool) -> str:
    return "bwd" if reverse else "fwd"


def run_tri_dir_partial_h2_plain(cost, hf, hb, P1: int, P2: int, reverse: bool) -> torch.Tensor:
    """Plain form of _run_tri_dir_partial_h2: int16 hf + hb + one walk."""
    return walk_add(cost, _h2_sum(hf, hb), _tri(reverse), P1, P2)


def run_tri_dir_wta_plain(cost, partial, P1: int, P2: int, reverse: bool, min_disp: int, uniq: int) -> torch.Tensor:
    """Plain form of _run_tri_dir_wta: the WTA of partial + one walk,
    (H, W) float32.  The walk adds into `partial` in place."""
    return wta_disparity(walk_add(cost, partial, _tri(reverse), P1, P2), min_disp, uniq)


def run_tri_dir_wta_h2_plain(cost, hf, hb, P1: int, P2: int, reverse: bool, min_disp: int, uniq: int) -> torch.Tensor:
    """Plain form of _run_tri_dir_wta_h2: the WTA of hf + hb + one walk."""
    return run_tri_dir_wta_plain(cost, _h2_sum(hf, hb), P1, P2, reverse, min_disp, uniq)


def run_tri_dir_partial_windowed_h2_plain(cost, hf, hb, wstart_tiles, P1: int, P2: int, reverse: bool) -> torch.Tensor:
    """Plain form of _run_tri_dir_partial_windowed_h2."""
    return walk_add(cost, _h2_sum(hf, hb), _tri(reverse), P1, P2, wstart_tiles)


def run_tri_dir_wta_windowed_plain(cost, partial, wstart_tiles, P1: int, P2: int, reverse: bool,
                                   uniq: int) -> torch.Tensor:
    """Plain form of _run_tri_dir_wta_windowed, in true disparity units as
    wta_disparity_windowed gives them.  Adds into `partial` in place."""
    agg = walk_add(cost, partial, _tri(reverse), P1, P2, wstart_tiles)
    return wta_disparity_windowed(agg, wstart_tiles.repeat_interleave(TILE_ROWS), uniq)


def run_tri_dir_wta_windowed_h2_plain(cost, hf, hb, wstart_tiles, P1: int, P2: int, reverse: bool,
                                      uniq: int) -> torch.Tensor:
    """Plain form of _run_tri_dir_wta_windowed_h2, in true disparity units."""
    return run_tri_dir_wta_windowed_plain(cost, _h2_sum(hf, hb), wstart_tiles, P1, P2, reverse, uniq)


def sgm_disparity(
    base_img: torch.Tensor,
    match_img: torch.Tensor,
    num_disp: int,
    min_disp: int = 1,
    P1: int = 8,
    P2: int = 96,
    directions: int = 8,
    census_win: Tuple[int, int] = (7, 9),
    uniqueness_ratio: int = 1,
    lr_max_diff: int = -1,
    input_smooth_sigma: float = 0.0,
) -> torch.Tensor:
    """Dense disparity over the full range: census -> cost volume (K1) ->
    SGM + WTA (K3 for the 5- and 8-path sets without the left-right
    check, else K5 and the plain WTA).  CUDA tensors run the kernels, CPU
    tensors their plain versions."""
    from wass_tpu_torch.stereo import sgm_kernels

    cb = sgm_kernels.census_transform(base_img, census_win, input_smooth_sigma)
    cm = sgm_kernels.census_transform(match_img, census_win, input_smooth_sigma)
    return sgm_disparity_census(cb, cm, num_disp, min_disp, P1, P2, directions, uniqueness_ratio, lr_max_diff)


def sgm_disparity_census(
    cb: torch.Tensor,
    cm: torch.Tensor,
    num_disp: int,
    min_disp: int,
    P1: int,
    P2: int,
    directions: int,
    uniqueness_ratio: int,
    lr_max_diff: int,
) -> torch.Tensor:
    """The full-range branch of sgm_disparity from the two census maps."""
    from wass_tpu_torch.stereo import sgm_kernels

    cost = sgm_kernels.census_cost_volume(cb, cm, num_disp, min_disp)
    if directions in (5, 8) and lr_max_diff < 0:
        return sgm_kernels.sgm_wta_fused(cost, P1, P2, directions, min_disp, uniqueness_ratio)
    agg = sgm_kernels.sgm_aggregate(cost, P1, P2, directions)
    return wta_disparity(agg, min_disp, uniqueness_ratio, lr_max_diff)
