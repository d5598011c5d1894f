"""Coarse-to-fine (c2f) disparity windowing for dense SGM.

Counterpart of wass_tpu/stereo/c2f.py.  On an obliquely viewed sea
surface the disparity is nearly a function of the image row, so the full
search range is several times wider than any one row needs.  A
full-range SGM at 1/factor resolution (K1 + K3) gives a coarse map; each
8-row tile of the full-resolution image gets a window of win_disp
disparities centred on the robust band of its coarse rows; the
full-resolution census cost (K2), SGM and WTA (K4, or K6 and the plain
windowed WTA for 2 paths) then run over the window only.

Every float step follows the JAX package's order, so the window starts,
and from them the disparity, match it bit for bit: the pool sums its
factor x factor block row by row from zero (XLA's CPU order), the
quantile ranks truncate float32 products, and the window centre rounds
half to even.
"""

from __future__ import annotations

from typing import Tuple

import torch

from wass_tpu_torch.stereo.sgm import TILE_ROWS, sgm_disparity, wta_disparity_windowed

__all__ = [
    "TILE_ROWS",
    "c2f_supported",
    "coarse_disparity",
    "coarse_num_disp",
    "compute_row_windows",
    "downsample_pool",
    "sgm_disparity_c2f",
    "windowed_disparity",
    "wta_disparity_windowed",
]

_BIGF = 1e9
_SMOOTH_ROWS = 2  # coarse rows each side that widen a row's band
_Q_LO, _Q_HI = 0.25, 0.75  # the robust band: interquartile range of a row's valid disparities


def downsample_pool(img: torch.Tensor, factor: int) -> torch.Tensor:
    """Mean over factor x factor blocks, summed in the reference's order
    (block row by block row, left to right) and divided by factor**2."""
    H, W = img.shape
    x = img.reshape(H // factor, factor, W // factor, factor)
    acc = x[:, 0, :, 0]
    for i in range(factor):
        for k in range(factor):
            if i or k:
                acc = acc + x[:, i, :, k]
    return acc / float(factor * factor)


def _shift_fill(a: torch.Tensor, s: int, fill: float) -> torch.Tensor:
    if s > 0:
        return torch.cat([torch.full((s,), fill, dtype=a.dtype, device=a.device), a[:-s]])
    if s < 0:
        return torch.cat([a[-s:], torch.full((-s,), fill, dtype=a.dtype, device=a.device)])
    return a


def compute_row_windows(
    disp_coarse: torch.Tensor,
    factor: int,
    num_disp: int,
    min_disp: int,
    win_disp: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-tile window starts from a coarse (H/factor, W/factor) disparity
    map in coarse pixels (0 = invalid).

    Returns (wstart (H // TILE_ROWS,) int32, coverage, offband), the last
    two 0-d float32 tensors: wstart is the interquartile band of each
    coarse row's valid disparities, widened over _SMOOTH_ROWS neighbours,
    centred and clipped to [min_disp, min_disp + num_disp - win_disp];
    rows with no valid pixel inherit the global band.  coverage is the
    share of considered coarse pixels (valid and right of their row's
    unmatched border) whose disparity lies in their window; offband the
    share that lies outside and whose 4 neighbours do too (a coherent
    object off the band, which should send the frame to full range)."""
    Hc, Wc = disp_coarse.shape
    if not (TILE_ROWS % factor == 0 or factor % TILE_ROWS == 0):
        raise ValueError(f"TILE_ROWS {TILE_ROWS} and factor {factor} must divide one another")
    cpt = max(1, TILE_ROWS // factor)  # coarse rows per full-res tile
    n_tiles = (Hc * factor) // TILE_ROWS
    if n_tiles * cpt != Hc:
        raise ValueError("image height must tile evenly")
    dev = disp_coarse.device
    f32 = torch.float32

    valid = disp_coarse > 0
    dfull = disp_coarse * factor
    srt = torch.sort(torch.where(valid, dfull, _BIGF), dim=1).values
    nv = valid.sum(1)
    lo_idx = (nv.to(f32) * _Q_LO).to(torch.int32).clamp(0, Wc - 1)
    hi_idx = torch.minimum((nv.to(f32) * _Q_HI).to(torch.int32).clamp_min(0), (nv - 1).clamp_min(0))
    rmin0 = torch.gather(srt, 1, lo_idx[:, None].to(torch.int64))[:, 0]
    rmax0 = torch.gather(srt, 1, hi_idx[:, None].to(torch.int64))[:, 0]
    rmin0 = torch.where(nv > 0, rmin0, _BIGF)
    rmax0 = torch.where(nv > 0, rmax0, -_BIGF)

    rmin, rmax = rmin0, rmax0
    for s in range(-_SMOOTH_ROWS, _SMOOTH_ROWS + 1):
        if s:
            rmin = torch.minimum(rmin, _shift_fill(rmin0, s, _BIGF))
            rmax = torch.maximum(rmax, _shift_fill(rmax0, s, -_BIGF))

    # Rows with no coarse evidence inherit the global valid range (or the
    # full search range when the whole coarse map is empty).
    gmin = torch.where(rmin < _BIGF / 2, rmin, _BIGF).amin()
    gmax = torch.where(rmax > -_BIGF / 2, rmax, -_BIGF).amax()
    gmin = torch.where(gmin < _BIGF / 2, gmin, float(min_disp))
    gmax = torch.where(gmax > -_BIGF / 2, gmax, float(min_disp + num_disp - 1))
    rmin = torch.where(rmin < _BIGF / 2, rmin, gmin)
    rmax = torch.where(rmax > -_BIGF / 2, rmax, gmax)

    wmin = rmin.reshape(n_tiles, cpt).amin(1)
    wmax = rmax.reshape(n_tiles, cpt).amax(1)
    center = 0.5 * (wmin + wmax)
    wstart = torch.round(center - win_disp / 2.0).to(torch.int32)
    wstart = wstart.clamp(min_disp, min_disp + num_disp - win_disp)

    # Coverage diagnostics; the left-border pixels (full-res column left of
    # the row's band) can never match and are left out.
    tile_of_row = torch.arange(Hc, device=dev) // cpt
    ws_c = wstart[tile_of_row].to(f32)[:, None]
    inside = (dfull >= ws_c) & (dfull <= ws_c + (win_disp - 1))
    xfull = (torch.arange(Wc, dtype=f32, device=dev) + 0.5) * factor
    considered = valid & (xfull[None, :] >= rmax[:, None])
    ncons = considered.sum().clamp_min(1).to(f32)
    coverage = (inside & considered).sum().to(f32) / ncons
    # Erode the outside-window mask by its 4-neighbourhood: isolated wrong
    # matches vanish, an off-band object survives.  Border rows and
    # columns keep their own value.
    out = ~inside & considered
    coh = out
    for ax, s in ((0, 1), (0, -1), (1, 1), (1, -1)):
        shifted = torch.roll(out, s, ax).clone()
        edge = 0 if s == 1 else out.shape[ax] - 1
        shifted.select(ax, edge).fill_(True)
        coh = coh & shifted
    offband = coh.sum().to(f32) / ncons
    return wstart, coverage, offband


def c2f_supported(
    H: int, W: int, num_disp: int, win_disp: int, factor: int, directions: int, lr_max_diff: int = -1
) -> bool:
    """Shapes the windowed kernels take (the gate of the c2f branch)."""
    return (
        0 < win_disp < num_disp
        and win_disp % 4 == 0
        and num_disp % 4 == 0
        and H % (factor * TILE_ROWS) == 0
        and W % factor == 0
        and (H // factor) % TILE_ROWS == 0
        and directions in (2, 5, 8)
        and lr_max_diff < 0
    )


def coarse_num_disp(num_disp: int, factor: int) -> int:
    """Coarse search range covering num_disp / factor, rounded up to a
    multiple of 8."""
    n = -(-num_disp // factor)
    return -(-n // 8) * 8


def coarse_disparity(
    base_img: torch.Tensor,
    match_img: torch.Tensor,
    num_disp: int,
    min_disp: int,
    P1: int,
    P2: int,
    directions: int,
    census_win: Tuple[int, int],
    uniqueness_ratio: int,
    factor: int,
) -> torch.Tensor:
    """The full-range pass at 1/factor resolution, unsmoothed, with 8 paths
    where the fine pass takes 5 (wass_tpu/stereo/dense.py:_jit_c2f_coarse)."""
    return sgm_disparity(
        downsample_pool(base_img, factor),
        downsample_pool(match_img, factor),
        num_disp=coarse_num_disp(num_disp, factor),
        min_disp=max(1, min_disp // factor),
        P1=P1,
        P2=P2,
        directions=directions if directions != 5 else 8,
        census_win=census_win,
        uniqueness_ratio=uniqueness_ratio,
    )


def windowed_disparity(
    cb: torch.Tensor,
    cm: torch.Tensor,
    wstart: torch.Tensor,
    win_disp: int,
    P1: int,
    P2: int,
    directions: int,
    uniqueness_ratio: int,
) -> torch.Tensor:
    """The full-resolution pass over the windows: K2, then K4 (5 or 8
    paths) or K6 and the plain windowed WTA (2 paths)."""
    from wass_tpu_torch.stereo import sgm_kernels

    cost = sgm_kernels.census_cost_volume_windowed(cb, cm, wstart, win_disp)
    if directions in (5, 8):
        return sgm_kernels.sgm_wta_fused_windowed(cost, wstart, P1, P2, directions, uniqueness_ratio)
    agg = sgm_kernels.sgm_aggregate_windowed(cost, wstart, P1, P2, directions)
    return wta_disparity_windowed(agg, wstart.repeat_interleave(TILE_ROWS), uniqueness_ratio)


def sgm_disparity_c2f(
    base_img: torch.Tensor,
    match_img: torch.Tensor,
    num_disp: int,
    min_disp: int = 1,
    P1: int = 8,
    P2: int = 96,
    directions: int = 8,
    census_win: Tuple[int, int] = (7, 9),
    uniqueness_ratio: int = 1,
    factor: int = 4,
    win_disp: int = 128,
    input_smooth_sigma: float = 0.0,
) -> torch.Tensor:
    """Coarse-to-fine disparity of a rectified pair, with no fallback
    (DenseStereoPipeline decides that): coarse pass, windows, fine pass."""
    from wass_tpu_torch.stereo import sgm_kernels

    H, W = base_img.shape
    if not c2f_supported(H, W, num_disp, win_disp, factor, directions):
        raise ValueError(f"c2f does not take H={H} W={W} num_disp={num_disp} win_disp={win_disp} "
                         f"factor={factor} directions={directions}")
    disp_c = coarse_disparity(base_img, match_img, num_disp, min_disp, P1, P2, directions, census_win,
                              uniqueness_ratio, factor)
    wstart, _cov, _offband = compute_row_windows(disp_c, factor, num_disp, min_disp, win_disp)
    cb = sgm_kernels.census_transform(base_img, census_win, input_smooth_sigma)
    cm = sgm_kernels.census_transform(match_img, census_win, input_smooth_sigma)
    return windowed_disparity(cb, cm, wstart, win_disp, P1, P2, directions, uniqueness_ratio)
