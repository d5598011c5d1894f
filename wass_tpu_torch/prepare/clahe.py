"""Contrast-limited adaptive histogram equalization (cv::CLAHE equivalent).

Counterpart of wass_tpu/prepare/clahe.py.  The reference applies CLAHE
optionally before undistortion (wass_prepare.cpp:257-262, options
CAM{0,1}_CLAHE_{CLIPLIMIT,TILEGRIDSIZE} :36-39).  Per-tile histograms by
one scatter-add, the clip with uniform redistribution of the excess, a
cumulative sum to a per-tile lookup table, then each pixel blends the
tables of its four neighbouring tiles bilinearly.  Plain PyTorch on the
device of the image: the JAX package computes it outside Pallas too.
"""

from __future__ import annotations

import torch


def clahe(img: torch.Tensor, clip_limit: float = 2.0, tiles_x: int = 8, tiles_y: int = 8,
          n_bins: int = 256) -> torch.Tensor:
    """CLAHE of a (H, W) float image of uint8 range.

    tiles_x, tiles_y count the tiles, as cv::CLAHE's tileGridSize does; the
    reference's CLAHE_TILEGRIDSIZE option (150 suggested) is a tile's size
    in pixels, so callers convert: tiles = image size // tile size."""
    H, W = img.shape
    dev = img.device
    x = img.clamp(0.0, 255.0)
    bins = (x * (n_bins / 256.0)).to(torch.int64).clamp(0, n_bins - 1)

    ty = (torch.arange(H, device=dev) * tiles_y // H).clamp_max(tiles_y - 1)
    tx = (torch.arange(W, device=dev) * tiles_x // W).clamp_max(tiles_x - 1)
    tile_id = ty[:, None] * tiles_x + tx[None, :]
    flat_id = (tile_id * n_bins + bins).reshape(-1)
    hist = torch.zeros(tiles_y * tiles_x * n_bins, dtype=torch.float32, device=dev)
    hist.index_add_(0, flat_id, torch.ones(flat_id.numel(), dtype=torch.float32, device=dev))
    hist = hist.reshape(tiles_y * tiles_x, n_bins)

    # The clip limit scales with the tile's population, as OpenCV's.
    tile_count = hist.sum(1, keepdim=True)
    limit = torch.clamp_min(clip_limit * tile_count / n_bins, 1.0)
    clipped = torch.minimum(hist, limit)
    excess = (hist - clipped).sum(1, keepdim=True)
    clipped = clipped + excess / n_bins

    cdf = torch.cumsum(clipped, 1) / torch.clamp_min(tile_count, 1.0)
    luts = (cdf * 255.0).reshape(tiles_y, tiles_x, n_bins)

    # Pixel -> fractional tile coordinates (tile centres at (i + 0.5) * size).
    fy = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) / (H / tiles_y) - 0.5
    fx = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) / (W / tiles_x) - 0.5
    y0 = torch.floor(fy).to(torch.int64).clamp(0, tiles_y - 1)
    x0 = torch.floor(fx).to(torch.int64).clamp(0, tiles_x - 1)
    y1 = (y0 + 1).clamp(0, tiles_y - 1)
    x1 = (x0 + 1).clamp(0, tiles_x - 1)
    wy = (fy - y0).clamp(0.0, 1.0)[:, None]
    wx = (fx - x0).clamp(0.0, 1.0)[None, :]

    def lut_at(tyi, txi):
        return luts[tyi[:, None], txi[None, :], bins]

    v00, v01, v10, v11 = lut_at(y0, x0), lut_at(y0, x1), lut_at(y1, x0), lut_at(y1, x1)
    return v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx + v10 * wy * (1 - wx) + v11 * wy * wx
