"""Plain semi-global matching: path aggregation and winner-take-all.

Counterpart of wass_tpu/stereo/sgm.py.  Along a path r,

    L_r(p, d) = C(p, d) + min( L_r(p-r, d),
                               L_r(p-r, d-1) + P1,
                               L_r(p-r, d+1) + P1,
                               min_k L_r(p-r, k) + P2 ) - min_k L_r(p-r, k)

and the first pixel of a path has L = C.  Every L is a small integer
(C <= 64 and L <= C + P2 < 256), so the int16 sum over paths is exact in
any order.  These functions are the CPU path and the oracle of kernel K3
(stereo/sgm_kernels.py, csrc/sgm.cu); `sgm_wta_fused_plain` is the plain
form of the fused kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

_BIG = 32000
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


def _walk(c: torch.Tensor, agg: torch.Tensor, dy: int, dx: int, P1: int, P2: int) -> None:
    """Add the path costs of direction (dy, dx) to agg (in place)."""
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
        if dx > 0:  # the carry at x comes from x - 1 of the previous row
            L = torch.cat([big, L[:-1]], 0)
        elif dx < 0:
            L = torch.cat([L[1:], big], 0)
        L = _sgm_step(L, c[y].to(torch.int32), P1, P2)
        agg[y] += L.to(agg.dtype)


def sgm_aggregate(cost: torch.Tensor, P1: int, P2: int, directions: int = 8) -> torch.Tensor:
    """(H, W, D) uint8 cost -> (H, W, D) int16 sum over the path set
    `directions` (2, 4, 5 or 8)."""
    if directions not in DIRECTIONS:
        raise ValueError(f"directions must be one of {sorted(DIRECTIONS)}, got {directions}")
    _check_p2(P2)
    agg = torch.zeros(cost.shape, dtype=torch.int16, device=cost.device)
    for dy, dx in DIRECTIONS[directions]:
        _walk(cost, agg, dy, dx, P1, P2)
    return agg


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
    """Dense disparity: census -> cost volume (K1) -> SGM + WTA (K3 for the
    5- and 8-path sets without the left-right check).  CUDA tensors run
    the kernels, CPU tensors their plain versions; the unfused aggregation
    has no kernel yet, so on CUDA the path sets 2/4 and the left-right
    check raise."""
    from wass_tpu_torch.stereo.cost import census_transform
    from wass_tpu_torch.stereo import sgm_kernels

    cb = census_transform(base_img, census_win, input_smooth_sigma)
    cm = census_transform(match_img, census_win, input_smooth_sigma)
    cost = sgm_kernels.census_cost_volume(cb, cm, num_disp, min_disp)
    if directions in (5, 8) and lr_max_diff < 0:
        return sgm_kernels.sgm_wta_fused(cost, P1, P2, directions, min_disp, uniqueness_ratio)
    if cost.device.type != "cpu":
        raise NotImplementedError(
            "unfused SGM aggregation (directions 2/4, DENSE_DISP12MAXDIFF >= 0) has no CUDA kernel yet"
        )
    agg = sgm_aggregate(cost, P1, P2, directions)
    return wta_disparity(agg, min_disp, uniqueness_ratio, lr_max_diff)
