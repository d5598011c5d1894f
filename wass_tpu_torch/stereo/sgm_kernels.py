"""Wrappers of the dense-stereo CUDA kernels K1 and K3.

Counterpart of wass_tpu/stereo/sgm_pallas.py for the full-range path:

  K1 `census_cost_volume`  <- census_cost_volume_pallas  (csrc/census_cost.cu)
  K3 `sgm_wta_fused`       <- sgm_wta_fused_pallas       (csrc/sgm.cu)

A wrapper launches its kernel for CUDA tensors and runs the plain PyTorch
version (`census_cost_volume_plain`, `sgm_wta_fused_plain`) for CPU
tensors only.  LAUNCHES counts the kernel launches, so a run can show
that its main path went through the kernels.
"""

from __future__ import annotations

import torch

from wass_tpu_torch import _build
from wass_tpu_torch.device import on_cuda
from wass_tpu_torch.stereo.cost import census_cost_volume as census_cost_volume_plain
from wass_tpu_torch.stereo.sgm import _check_p2, sgm_wta_fused_plain

LAUNCHES = {"census_cost": 0, "sgm_wta_fused": 0}

__all__ = [
    "LAUNCHES",
    "census_cost_volume",
    "census_cost_volume_plain",
    "sgm_wta_fused",
    "sgm_wta_fused_plain",
]


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def census_cost_volume(
    census_base: torch.Tensor, census_match: torch.Tensor, num_disp: int, min_disp: int = 0
) -> torch.Tensor:
    """K1: (H, W, nw) int32 census words x 2 -> (H, W, num_disp) uint8 costs."""
    if not on_cuda(census_base, census_match):
        return census_cost_volume_plain(census_base, census_match, num_disp, min_disp)
    _require(census_base.dim() == 3 and census_base.shape == census_match.shape,
             f"census shapes differ or are not (H, W, nw): {tuple(census_base.shape)} vs {tuple(census_match.shape)}")
    _require(census_base.dtype == torch.int32 and census_match.dtype == torch.int32, "census words must be int32")
    _require(census_base.is_contiguous() and census_match.is_contiguous(), "census words must be contiguous")
    _require(num_disp >= 1 and min_disp >= 0, f"bad disparity range: num_disp={num_disp}, min_disp={min_disp}")
    H, W, nw = census_base.shape
    _require(1 <= nw <= 8, f"n_words must be in [1, 8], got {nw}")
    out = torch.empty((H, W, num_disp), dtype=torch.uint8, device=census_base.device)
    lib = _build.load()
    err = lib.wass_census_cost(
        census_base.data_ptr(), census_match.data_ptr(), out.data_ptr(),
        H, W, nw, num_disp, min_disp, _build.stream_handle(census_base.device),
    )
    _build.check(err, "census_cost kernel")
    LAUNCHES["census_cost"] += 1
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
        return sgm_wta_fused_plain(cost, P1, P2, directions, min_disp, uniqueness_ratio)
    _require(cost.dim() == 3 and cost.dtype == torch.uint8, "cost must be (H, W, D) uint8")
    _require(cost.is_contiguous(), "cost must be contiguous")
    _require(directions in (5, 8), f"the fused kernel takes 5 or 8 directions, got {directions}")
    _check_p2(P2)
    H, W, D = cost.shape
    lib = _build.load()
    _require(lib.wass_sgm_lane_width(D) > 0, f"num_disp must be in [1, 1024], got {D}")
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
