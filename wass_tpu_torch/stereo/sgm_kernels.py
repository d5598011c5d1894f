"""Wrappers of the dense-stereo CUDA kernels K1-K6.

Counterpart of wass_tpu/stereo/sgm_pallas.py:

  K1 `census_cost_volume`           <- census_cost_volume_pallas           (csrc/census_cost.cu)
  K2 `census_cost_volume_windowed`  <- census_cost_volume_pallas_windowed  (csrc/census_cost.cu)
  K3 `sgm_wta_fused`                <- sgm_wta_fused_pallas                (csrc/sgm.cu)
  K4 `sgm_wta_fused_windowed`       <- sgm_wta_fused_pallas_windowed       (csrc/sgm.cu)
  K5 `sgm_aggregate`                <- sgm_aggregate_pallas                (csrc/sgm.cu)
  K6 `sgm_aggregate_windowed`       <- sgm_aggregate_pallas_windowed       (csrc/sgm.cu)

A wrapper launches its kernel for CUDA tensors and runs the plain PyTorch
version (stereo/cost.py, stereo/sgm.py) for CPU tensors only.  LAUNCHES
counts the kernel launches, so a run can show that its main path went
through the kernels.  Windowed volumes take per-8-row-tile window starts
(stereo/c2f.py), int32 on the volume's device.
"""

from __future__ import annotations

import torch

from wass_tpu_torch import _build
from wass_tpu_torch.device import on_cuda
from wass_tpu_torch.stereo import cost as _cost
from wass_tpu_torch.stereo import sgm as _sgm
from wass_tpu_torch.stereo.sgm import TILE_ROWS, _check_p2

LAUNCHES = {
    "census_cost": 0,
    "census_cost_windowed": 0,
    "sgm_wta_fused": 0,
    "sgm_wta_fused_windowed": 0,
    "sgm_aggregate": 0,
    "sgm_aggregate_windowed": 0,
}

__all__ = [
    "LAUNCHES",
    "census_cost_volume",
    "census_cost_volume_windowed",
    "sgm_aggregate",
    "sgm_aggregate_windowed",
    "sgm_wta_fused",
    "sgm_wta_fused_windowed",
]


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_census(census_base: torch.Tensor, census_match: torch.Tensor) -> None:
    _require(census_base.dim() == 3 and census_base.shape == census_match.shape,
             f"census shapes differ or are not (H, W, nw): {tuple(census_base.shape)} vs {tuple(census_match.shape)}")
    _require(census_base.dtype == torch.int32 and census_match.dtype == torch.int32, "census words must be int32")
    _require(census_base.is_contiguous() and census_match.is_contiguous(), "census words must be contiguous")
    _require(1 <= census_base.shape[2] <= 8, f"n_words must be in [1, 8], got {census_base.shape[2]}")


def _check_cost(cost: torch.Tensor, P2: int) -> None:
    _require(cost.dim() == 3 and cost.dtype == torch.uint8, "cost must be (H, W, D) uint8")
    _require(cost.is_contiguous(), "cost must be contiguous")
    _check_p2(P2)


def _check_windows(wstart: torch.Tensor, H: int) -> None:
    _require(H % TILE_ROWS == 0, f"a windowed volume needs H % {TILE_ROWS} == 0, got H={H}")
    _require(wstart.shape == (H // TILE_ROWS,) and wstart.dtype == torch.int32 and wstart.is_contiguous(),
             f"window starts must be contiguous int32 of shape ({H // TILE_ROWS},), got "
             f"{wstart.dtype} {tuple(wstart.shape)}")


def _lane_width_ok(lib, D: int) -> None:
    _require(lib.wass_sgm_lane_width(D) > 0, f"num_disp must be in [1, 1024], got {D}")


def census_cost_volume(
    census_base: torch.Tensor, census_match: torch.Tensor, num_disp: int, min_disp: int = 0
) -> torch.Tensor:
    """K1: (H, W, nw) int32 census words x 2 -> (H, W, num_disp) uint8 costs."""
    if not on_cuda(census_base, census_match):
        return _cost.census_cost_volume(census_base, census_match, num_disp, min_disp)
    _check_census(census_base, census_match)
    _require(num_disp >= 1 and min_disp >= 0, f"bad disparity range: num_disp={num_disp}, min_disp={min_disp}")
    H, W, nw = census_base.shape
    out = torch.empty((H, W, num_disp), dtype=torch.uint8, device=census_base.device)
    lib = _build.load()
    err = lib.wass_census_cost(
        census_base.data_ptr(), census_match.data_ptr(), out.data_ptr(),
        H, W, nw, num_disp, min_disp, _build.stream_handle(census_base.device),
    )
    _build.check(err, "census_cost kernel")
    LAUNCHES["census_cost"] += 1
    return out


def census_cost_volume_windowed(
    census_base: torch.Tensor, census_match: torch.Tensor, wstart: torch.Tensor, win_disp: int
) -> torch.Tensor:
    """K2: census words x 2 + window starts (H // 8,) -> (H, W, win_disp)
    uint8 costs, lane j of row y at disparity wstart[y // 8] + j."""
    if not on_cuda(census_base, census_match, wstart):
        return _cost.census_cost_volume_windowed(census_base, census_match, wstart, win_disp)
    _check_census(census_base, census_match)
    H, W, nw = census_base.shape
    _check_windows(wstart, H)
    _require(win_disp >= 1 and win_disp % 4 == 0, f"win_disp must be a positive multiple of 4, got {win_disp}")
    out = torch.empty((H, W, win_disp), dtype=torch.uint8, device=census_base.device)
    lib = _build.load()
    err = lib.wass_census_cost_windowed(
        census_base.data_ptr(), census_match.data_ptr(), wstart.data_ptr(), out.data_ptr(),
        H, W, nw, win_disp, _build.stream_handle(census_base.device),
    )
    _build.check(err, "census_cost_windowed kernel")
    LAUNCHES["census_cost_windowed"] += 1
    return out


def sgm_wta_fused(
    cost: torch.Tensor,
    P1: int,
    P2: int,
    directions: int,
    min_disp: int,
    uniqueness_ratio: int = 1,
) -> torch.Tensor:
    """K3: (H, W, D) uint8 cost -> (H, W) float32 disparity (0 = invalid)
    through the 5- or 8-path SGM sum and the WTA of sgm.wta_disparity."""
    if not on_cuda(cost):
        return _sgm.sgm_wta_fused_plain(cost, P1, P2, directions, min_disp, uniqueness_ratio)
    _check_cost(cost, P2)
    _require(directions in (5, 8), f"the fused kernel takes 5 or 8 directions, got {directions}")
    H, W, D = cost.shape
    lib = _build.load()
    _lane_width_ok(lib, D)
    acc = torch.empty((H, W, D), dtype=torch.int16, device=cost.device)
    disp = torch.empty((H, W), dtype=torch.float32, device=cost.device)
    err = lib.wass_sgm_wta_fused(
        cost.data_ptr(), acc.data_ptr(), disp.data_ptr(),
        H, W, D, P1, P2, directions, min_disp, uniqueness_ratio,
        _build.stream_handle(cost.device),
    )
    _build.check(err, "sgm_wta_fused kernel")
    LAUNCHES["sgm_wta_fused"] += 1
    return disp


def sgm_wta_fused_windowed(
    cost: torch.Tensor,
    wstart: torch.Tensor,
    P1: int,
    P2: int,
    directions: int,
    uniqueness_ratio: int = 1,
) -> torch.Tensor:
    """K4: windowed (H, W, Dw) uint8 cost + window starts -> (H, W) float32
    disparity in true units (0 = invalid), as sgm.sgm_wta_fused_windowed_plain."""
    if not on_cuda(cost, wstart):
        return _sgm.sgm_wta_fused_windowed_plain(cost, wstart, P1, P2, directions, uniqueness_ratio)
    _check_cost(cost, P2)
    _require(directions in (5, 8), f"the fused kernel takes 5 or 8 directions, got {directions}")
    H, W, D = cost.shape
    _check_windows(wstart, H)
    lib = _build.load()
    _lane_width_ok(lib, D)
    acc = torch.empty((H, W, D), dtype=torch.int16, device=cost.device)
    disp = torch.empty((H, W), dtype=torch.float32, device=cost.device)
    err = lib.wass_sgm_wta_fused_windowed(
        cost.data_ptr(), wstart.data_ptr(), acc.data_ptr(), disp.data_ptr(),
        H, W, D, P1, P2, directions, uniqueness_ratio, _build.stream_handle(cost.device),
    )
    _build.check(err, "sgm_wta_fused_windowed kernel")
    LAUNCHES["sgm_wta_fused_windowed"] += 1
    return disp


def sgm_aggregate(cost: torch.Tensor, P1: int, P2: int, directions: int = 8) -> torch.Tensor:
    """K5: (H, W, D) uint8 cost -> (H, W, D) int16 sum over the path set
    `directions` (2, 4, 5 or 8)."""
    if not on_cuda(cost):
        return _sgm.sgm_aggregate(cost, P1, P2, directions)
    _check_cost(cost, P2)
    _require(directions in _sgm.DIRECTIONS, f"directions must be one of {sorted(_sgm.DIRECTIONS)}, got {directions}")
    H, W, D = cost.shape
    lib = _build.load()
    _lane_width_ok(lib, D)
    acc = torch.empty((H, W, D), dtype=torch.int16, device=cost.device)
    err = lib.wass_sgm_aggregate(
        cost.data_ptr(), acc.data_ptr(), H, W, D, P1, P2, directions, _build.stream_handle(cost.device),
    )
    _build.check(err, "sgm_aggregate kernel")
    LAUNCHES["sgm_aggregate"] += 1
    return acc


def sgm_aggregate_windowed(
    cost: torch.Tensor, wstart: torch.Tensor, P1: int, P2: int, directions: int = 8
) -> torch.Tensor:
    """K6: windowed (H, W, Dw) uint8 cost + window starts -> (H, W, Dw)
    int16 sum over the path set `directions` (2, 5 or 8)."""
    if not on_cuda(cost, wstart):
        return _sgm.sgm_aggregate_windowed(cost, wstart, P1, P2, directions)
    _check_cost(cost, P2)
    _require(directions in (2, 5, 8), f"the windowed aggregation takes 2, 5 or 8 directions, got {directions}")
    H, W, D = cost.shape
    _check_windows(wstart, H)
    lib = _build.load()
    _lane_width_ok(lib, D)
    acc = torch.empty((H, W, D), dtype=torch.int16, device=cost.device)
    err = lib.wass_sgm_aggregate_windowed(
        cost.data_ptr(), wstart.data_ptr(), acc.data_ptr(), H, W, D, P1, P2, directions,
        _build.stream_handle(cost.device),
    )
    _build.check(err, "sgm_aggregate_windowed kernel")
    LAUNCHES["sgm_aggregate_windowed"] += 1
    return acc
