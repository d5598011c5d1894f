"""Wrappers of the dense-stereo CUDA kernels: the census transform, K1-K6
and H2.

`census_transform` (csrc/census.cu) replaces no Pallas kernel: it is the
XLA fusion of wass_tpu/stereo/cost.py:census_transform and its pre-blur,
one launch an image.  The others are the counterparts of
wass_tpu/stereo/sgm_pallas.py:

  K1 `census_cost_volume`               <- census_cost_volume_pallas           (csrc/census_cost.cu)
  K2 `census_cost_volume_windowed`      <- census_cost_volume_pallas_windowed  (csrc/census_cost.cu)
  K3 `sgm_wta_fused`                    <- sgm_wta_fused_pallas                (csrc/sgm.cu)
  K4 `sgm_wta_fused_windowed`           <- sgm_wta_fused_pallas_windowed       (csrc/sgm.cu)
  K5 `sgm_aggregate`                    <- sgm_aggregate_pallas                (csrc/sgm.cu)
  K6 `sgm_aggregate_windowed`           <- sgm_aggregate_pallas_windowed       (csrc/sgm.cu)
  H2 `sgm_pair_img`                     <- _run_pair_img                       (csrc/sgm.cu)
     `sgm_tri_dir_partial_h2`           <- _run_tri_dir_partial_h2             (csrc/sgm.cu)
     `sgm_tri_dir_wta_h2`               <- _run_tri_dir_wta_h2                 (csrc/sgm.cu)
     `sgm_tri_dir_partial_windowed_h2`  <- _run_tri_dir_partial_windowed_h2    (csrc/sgm.cu)
     `sgm_tri_dir_wta_windowed_h2`      <- _run_tri_dir_wta_windowed_h2        (csrc/sgm.cu)
     `sgm_tri_dir_wta`, `sgm_tri_dir_wta_windowed`, `sgm_walk_add`
                                        <- _run_tri_dir_wta, _run_tri_dir_wta_windowed,
                                           _run_tri_dir, _run_tri_dir_windowed

With `_USE_H2` set (read at call time; False by default, as the JAX
package's flag), K3-K6 run the H2 compositions of sgm_pallas.py: the
horizontal pair in image layout as two uint8 volumes, folded into the
first row walk, and then the single non-H2 walks (the last three above),
which count as launches of `sgm_walk`.  So with H2 on, the K3-K6 keys
stay at 0.

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
from wass_tpu_torch.instrument import LaunchCounts
from wass_tpu_torch.stereo import cost as _cost
from wass_tpu_torch.stereo import sgm as _sgm
from wass_tpu_torch.stereo.sgm import TILE_ROWS, _check_p2, _tri

LAUNCHES = LaunchCounts({
    "census": 0,
    "census_cost": 0,
    "census_cost_windowed": 0,
    "sgm_wta_fused": 0,
    "sgm_wta_fused_windowed": 0,
    "sgm_aggregate": 0,
    "sgm_aggregate_windowed": 0,
    "sgm_pair_img": 0,
    "sgm_tri_dir_partial_h2": 0,
    "sgm_tri_dir_wta_h2": 0,
    "sgm_tri_dir_partial_windowed_h2": 0,
    "sgm_tri_dir_wta_windowed_h2": 0,
    "sgm_walk": 0,
})

# The horizontal pair in image layout, folded into the row walks
# (wass_tpu/stereo/sgm_pallas.py:_USE_H2); off by default, as there.
_USE_H2 = False

__all__ = [
    "LAUNCHES",
    "census_cost_volume",
    "census_cost_volume_windowed",
    "census_transform",
    "sgm_aggregate",
    "sgm_aggregate_windowed",
    "sgm_pair_img",
    "sgm_tri_dir_partial_h2",
    "sgm_tri_dir_partial_windowed_h2",
    "sgm_tri_dir_wta",
    "sgm_tri_dir_wta_h2",
    "sgm_tri_dir_wta_windowed",
    "sgm_tri_dir_wta_windowed_h2",
    "sgm_walk_add",
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


# (sigma, radius, device) -> the pre-blur's taps on that card, made by the
# plain version's own function, so the kernel multiplies by the same bits.
_BLUR_TAPS: dict = {}


def _blur_taps(sigma: float, radius: int, device) -> torch.Tensor:
    key = (sigma, radius, device)
    taps = _BLUR_TAPS.get(key)
    if taps is None:
        taps = _cost._gauss_kernel1d(sigma, radius, device)
        # Written once on this thread's stream, then read from every
        # stream (the writers' re-runs): let it land first.
        torch.cuda.current_stream(device).synchronize()
        _BLUR_TAPS[key] = taps
    return taps


def census_transform(img: torch.Tensor, win=(7, 9), smooth_sigma: float = 0.0) -> torch.Tensor:
    """(H, W) float32 -> (H, W, nw) int32 census words, bit-equal to
    cost.census_transform (a negative smooth_sigma is its AUTO sentinel,
    a positive one its Gaussian pre-blur), in one launch."""
    if not on_cuda(img):
        return _cost.census_transform(img, win, smooth_sigma)
    wy, wx = win
    _require(wy % 2 == 1 and wx % 2 == 1, f"census window must be odd, got {win}")
    nw = (wy * wx - 1 + 31) // 32
    _require(1 <= nw <= 8, f"the census window must give 1 to 8 words, got {win}")
    _require(img.dim() == 2 and img.dtype == torch.float32 and img.is_contiguous(),
             f"the image must be contiguous (H, W) float32, got {img.dtype} {tuple(img.shape)}")
    sigma = _cost.AUTO_SIGMA if smooth_sigma is not None and smooth_sigma < 0 else smooth_sigma
    radius = max(1, int(3.0 * sigma + 0.5)) if sigma and sigma > 0 else 0  # cost.gauss_blur's
    H, W = img.shape
    out = torch.empty((H, W, nw), dtype=torch.int32, device=img.device)
    if out.numel() == 0:
        return out
    taps = _blur_taps(float(sigma), radius, img.device) if radius else None
    _build.launch("wass_census_transform", "census_transform kernel", img.device,
                  img.data_ptr(), _ptr(taps), out.data_ptr(), H, W, radius, wy, wx)
    LAUNCHES.add("census")
    return out


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
    _build.launch("wass_census_cost", "census_cost kernel", census_base.device,
                  census_base.data_ptr(), census_match.data_ptr(), out.data_ptr(),
                  H, W, nw, num_disp, min_disp)
    LAUNCHES.add("census_cost")
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
    _build.launch("wass_census_cost_windowed", "census_cost_windowed kernel", census_base.device,
                  census_base.data_ptr(), census_match.data_ptr(), wstart.data_ptr(), out.data_ptr(),
                  H, W, nw, win_disp)
    LAUNCHES.add("census_cost_windowed")
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
    if _USE_H2:  # sgm_pallas.py:650-663
        _require(directions in (5, 8), f"the fused kernel takes 5 or 8 directions, got {directions}")
        hf, hb = sgm_pair_img(cost, P1, P2)
        if directions == 5:
            return sgm_tri_dir_wta_h2(cost, hf, hb, P1, P2, False, min_disp, uniqueness_ratio)
        partial = sgm_tri_dir_partial_h2(cost, hf, hb, P1, P2, False)
        del hf, hb
        return sgm_tri_dir_wta(cost, partial, P1, P2, True, min_disp, uniqueness_ratio)
    if not on_cuda(cost):
        return _sgm.sgm_wta_fused_plain(cost, P1, P2, directions, min_disp, uniqueness_ratio)
    _check_cost(cost, P2)
    _require(directions in (5, 8), f"the fused kernel takes 5 or 8 directions, got {directions}")
    H, W, D = cost.shape
    lib = _build.load()
    _lane_width_ok(lib, D)
    acc = torch.empty((H, W, D), dtype=torch.int16, device=cost.device)
    disp = torch.empty((H, W), dtype=torch.float32, device=cost.device)
    _build.launch("wass_sgm_wta_fused", "sgm_wta_fused kernel", cost.device,
                  cost.data_ptr(), acc.data_ptr(), disp.data_ptr(),
                  H, W, D, P1, P2, directions, min_disp, uniqueness_ratio)
    LAUNCHES.add("sgm_wta_fused")
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
    if _USE_H2:  # sgm_pallas.py:1245-1259; the pair takes no window starts
        _require(directions in (5, 8), f"the fused kernel takes 5 or 8 directions, got {directions}")
        hf, hb = sgm_pair_img(cost, P1, P2)
        if directions == 5:
            return sgm_tri_dir_wta_windowed_h2(cost, hf, hb, wstart, P1, P2, False, uniqueness_ratio)
        partial = sgm_tri_dir_partial_windowed_h2(cost, hf, hb, wstart, P1, P2, False)
        del hf, hb
        return sgm_tri_dir_wta_windowed(cost, partial, wstart, P1, P2, True, uniqueness_ratio)
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
    _build.launch("wass_sgm_wta_fused_windowed", "sgm_wta_fused_windowed kernel", cost.device,
                  cost.data_ptr(), wstart.data_ptr(), acc.data_ptr(), disp.data_ptr(),
                  H, W, D, P1, P2, directions, uniqueness_ratio)
    LAUNCHES.add("sgm_wta_fused_windowed")
    return disp


def sgm_aggregate(cost: torch.Tensor, P1: int, P2: int, directions: int = 8) -> torch.Tensor:
    """K5: (H, W, D) uint8 cost -> (H, W, D) int16 sum over the path set
    `directions` (2, 4, 5 or 8)."""
    if _USE_H2:  # sgm_pallas.py:323-348
        _require(directions in _sgm.DIRECTIONS, f"directions must be one of {sorted(_sgm.DIRECTIONS)}, got {directions}")
        return _aggregate_h2(cost, None, P1, P2, {2: (), 4: ("vert",), 5: ("fwd",), 8: ("fwd", "bwd")}[directions])
    if not on_cuda(cost):
        return _sgm.sgm_aggregate(cost, P1, P2, directions)
    _check_cost(cost, P2)
    _require(directions in _sgm.DIRECTIONS, f"directions must be one of {sorted(_sgm.DIRECTIONS)}, got {directions}")
    H, W, D = cost.shape
    lib = _build.load()
    _lane_width_ok(lib, D)
    acc = torch.empty((H, W, D), dtype=torch.int16, device=cost.device)
    _build.launch("wass_sgm_aggregate", "sgm_aggregate kernel", cost.device,
                  cost.data_ptr(), acc.data_ptr(), H, W, D, P1, P2, directions)
    LAUNCHES.add("sgm_aggregate")
    return acc


def sgm_aggregate_windowed(
    cost: torch.Tensor, wstart: torch.Tensor, P1: int, P2: int, directions: int = 8
) -> torch.Tensor:
    """K6: windowed (H, W, Dw) uint8 cost + window starts -> (H, W, Dw)
    int16 sum over the path set `directions` (2, 5 or 8)."""
    if _USE_H2:  # sgm_pallas.py:1301-1321
        _require(directions in (2, 5, 8), f"the windowed aggregation takes 2, 5 or 8 directions, got {directions}")
        return _aggregate_h2(cost, wstart, P1, P2, {2: (), 5: ("fwd",), 8: ("fwd", "bwd")}[directions])
    if not on_cuda(cost, wstart):
        return _sgm.sgm_aggregate_windowed(cost, wstart, P1, P2, directions)
    _check_cost(cost, P2)
    _require(directions in (2, 5, 8), f"the windowed aggregation takes 2, 5 or 8 directions, got {directions}")
    H, W, D = cost.shape
    _check_windows(wstart, H)
    lib = _build.load()
    _lane_width_ok(lib, D)
    acc = torch.empty((H, W, D), dtype=torch.int16, device=cost.device)
    _build.launch("wass_sgm_aggregate_windowed", "sgm_aggregate_windowed kernel", cost.device,
                  cost.data_ptr(), wstart.data_ptr(), acc.data_ptr(), H, W, D, P1, P2, directions)
    LAUNCHES.add("sgm_aggregate_windowed")
    return acc


# ---------------------------------------------------------------------------
# H2 and the single walks of its compositions.  Each runs its plain version
# (stereo/sgm.py) on CPU tensors.  The walks that take a partial sum add
# into it in place, on the card and on the CPU alike.


def _aggregate_h2(cost, wstart, P1, P2, walks) -> torch.Tensor:
    """hf + hb as int16 (torch ops, as XLA adds them in the JAX package),
    then each walk added in place."""
    hf, hb = sgm_pair_img(cost, P1, P2)
    agg = _sgm._h2_sum(hf, hb)
    del hf, hb
    for walk in walks:
        sgm_walk_add(cost, agg, walk, P1, P2, wstart)
    return agg


def _check_u8_like(cost: torch.Tensor, *vols: torch.Tensor) -> None:
    for v in vols:
        _require(v.shape == cost.shape and v.dtype == torch.uint8 and v.is_contiguous(),
                 f"hf and hb must be contiguous uint8 of the cost's shape {tuple(cost.shape)}")


def _check_partial(cost: torch.Tensor, acc: torch.Tensor) -> None:
    _require(acc.shape == cost.shape and acc.dtype == torch.int16 and acc.is_contiguous(),
             f"the partial sum must be contiguous int16 of the cost's shape {tuple(cost.shape)}")


_WALK_CODES = {"fwd": 0, "bwd": 1, "vert": 2}


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_walk(key, cost, acc, walk, P1, P2, wstart=None, hf=None, hb=None, wta=False, min_disp=0, uniq=1):
    """One walk on the card (csrc/sgm.cu:wass_sgm_walk), counted under
    `key`.  With hf and hb its first direction writes hf + hb + L to acc,
    else every direction adds into acc.  Returns the WTA disparity for
    wta, else acc."""
    _check_cost(cost, P2)
    H, W, D = cost.shape
    if wstart is not None:
        _check_windows(wstart, H)
    if hf is not None:
        _check_u8_like(cost, hf, hb)
    _check_partial(cost, acc)
    lib = _build.load()
    _lane_width_ok(lib, D)
    disp = torch.empty((H, W), dtype=torch.float32, device=cost.device) if wta else None
    _build.launch("wass_sgm_walk", f"{key} kernel", cost.device,
                  cost.data_ptr(), _ptr(wstart), _ptr(hf), _ptr(hb), acc.data_ptr(), _ptr(disp),
                  H, W, D, P1, P2, _WALK_CODES[walk], int(wta), min_disp, uniq)
    LAUNCHES.add(key)
    return disp if wta else acc


def sgm_pair_img(cost: torch.Tensor, P1: int, P2: int):
    """H2 _run_pair_img: (H, W, D) uint8 cost -> (hf, hb) uint8, the
    left-to-right and right-to-left path costs at their true positions."""
    if not on_cuda(cost):
        return _sgm.run_pair_img_plain(cost, P1, P2)
    _check_cost(cost, P2)
    H, W, D = cost.shape
    lib = _build.load()
    _lane_width_ok(lib, D)
    hf, hb = torch.empty_like(cost), torch.empty_like(cost)
    _build.launch("wass_sgm_pair_img", "sgm_pair_img kernel", cost.device,
                  cost.data_ptr(), hf.data_ptr(), hb.data_ptr(), H, W, D, P1, P2)
    LAUNCHES.add("sgm_pair_img")
    return hf, hb


def sgm_tri_dir_partial_h2(cost, hf, hb, P1: int, P2: int, reverse: bool) -> torch.Tensor:
    """H2 _run_tri_dir_partial_h2: int16 hf + hb + one row walk."""
    if not on_cuda(cost, hf, hb):
        return _sgm.run_tri_dir_partial_h2_plain(cost, hf, hb, P1, P2, reverse)
    acc = torch.empty(cost.shape, dtype=torch.int16, device=cost.device)
    return _launch_walk("sgm_tri_dir_partial_h2", cost, acc, _tri(reverse), P1, P2, hf=hf, hb=hb)


def sgm_tri_dir_wta_h2(cost, hf, hb, P1: int, P2: int, reverse: bool, min_disp: int, uniq: int) -> torch.Tensor:
    """H2 _run_tri_dir_wta_h2: the WTA of hf + hb + one row walk, (H, W)
    float32 (the 5-path set in one walk)."""
    if not on_cuda(cost, hf, hb):
        return _sgm.run_tri_dir_wta_h2_plain(cost, hf, hb, P1, P2, reverse, min_disp, uniq)
    acc = torch.empty(cost.shape, dtype=torch.int16, device=cost.device)
    return _launch_walk("sgm_tri_dir_wta_h2", cost, acc, _tri(reverse), P1, P2, hf=hf, hb=hb, wta=True,
                        min_disp=min_disp, uniq=uniq)


def sgm_tri_dir_partial_windowed_h2(cost, hf, hb, wstart, P1: int, P2: int, reverse: bool) -> torch.Tensor:
    """H2 _run_tri_dir_partial_windowed_h2: hf + hb + one row walk over a
    windowed volume (the carries realign, hf and hb do not)."""
    if not on_cuda(cost, hf, hb, wstart):
        return _sgm.run_tri_dir_partial_windowed_h2_plain(cost, hf, hb, wstart, P1, P2, reverse)
    acc = torch.empty(cost.shape, dtype=torch.int16, device=cost.device)
    return _launch_walk("sgm_tri_dir_partial_windowed_h2", cost, acc, _tri(reverse), P1, P2, wstart, hf, hb)


def sgm_tri_dir_wta_windowed_h2(cost, hf, hb, wstart, P1: int, P2: int, reverse: bool, uniq: int) -> torch.Tensor:
    """H2 _run_tri_dir_wta_windowed_h2: the windowed WTA of hf + hb + one
    row walk, (H, W) float32 in true disparity units (0 = invalid)."""
    if not on_cuda(cost, hf, hb, wstart):
        return _sgm.run_tri_dir_wta_windowed_h2_plain(cost, hf, hb, wstart, P1, P2, reverse, uniq)
    acc = torch.empty(cost.shape, dtype=torch.int16, device=cost.device)
    return _launch_walk("sgm_tri_dir_wta_windowed_h2", cost, acc, _tri(reverse), P1, P2, wstart, hf, hb,
                        wta=True, uniq=uniq)


def sgm_tri_dir_wta(cost, partial, P1: int, P2: int, reverse: bool, min_disp: int, uniq: int) -> torch.Tensor:
    """_run_tri_dir_wta: the WTA of partial + one row walk (the H2 8-path
    final walk).  The walk adds its first two directions into `partial` in
    place."""
    if not on_cuda(cost, partial):
        return _sgm.run_tri_dir_wta_plain(cost, partial, P1, P2, reverse, min_disp, uniq)
    return _launch_walk("sgm_walk", cost, partial, _tri(reverse), P1, P2, wta=True, min_disp=min_disp, uniq=uniq)


def sgm_tri_dir_wta_windowed(cost, partial, wstart, P1: int, P2: int, reverse: bool, uniq: int) -> torch.Tensor:
    """_run_tri_dir_wta_windowed, in true disparity units.  The walk adds
    its first two directions into `partial` in place."""
    if not on_cuda(cost, partial, wstart):
        return _sgm.run_tri_dir_wta_windowed_plain(cost, partial, wstart, P1, P2, reverse, uniq)
    return _launch_walk("sgm_walk", cost, partial, _tri(reverse), P1, P2, wstart, wta=True, uniq=uniq)


def sgm_walk_add(cost, acc, walk: str, P1: int, P2: int, wstart=None) -> torch.Tensor:
    """_run_tri_dir (_run_tri_dir_windowed with window starts; the
    vertical pair for "vert"): adds the walk `walk` (a key of sgm.WALKS) to
    the int16 volume acc in place and returns it."""
    tensors = (cost, acc) if wstart is None else (cost, acc, wstart)
    if not on_cuda(*tensors):
        return _sgm.walk_add(cost, acc, walk, P1, P2, wstart)
    _require(walk in _WALK_CODES, f"walk must be one of {sorted(_WALK_CODES)}, got {walk!r}")
    return _launch_walk("sgm_walk", cost, acc, walk, P1, P2, wstart)
