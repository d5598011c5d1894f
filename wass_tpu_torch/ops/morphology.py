"""Zero-aware morphology, median and Sobel filters for disparity maps.

Counterpart of wass_tpu/ops/morphology.py ("zero" is the invalid
disparity).  Neighbour sums are taken in a fixed order, so the results do
not depend on the device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _shifted_8(x: torch.Tensor) -> list:
    """The 8 neighbours of each pixel, zero-padded at the borders."""
    p = F.pad(x, (1, 1, 1, 1))
    H, W = x.shape
    return [
        p[0:H, 0:W], p[0:H, 1 : W + 1], p[0:H, 2 : W + 2],
        p[1 : H + 1, 0:W], p[1 : H + 1, 2 : W + 2],
        p[2 : H + 2, 0:W], p[2 : H + 2, 1 : W + 1], p[2 : H + 2, 2 : W + 2],
    ]


def _interior(x: torch.Tensor) -> torch.Tensor:
    m = torch.zeros_like(x, dtype=torch.bool)
    m[1:-1, 1:-1] = True
    return m


def dilate_zero(x: torch.Tensor) -> torch.Tensor:
    """Fill zero interior pixels with the mean of their > 0 8-neighbours
    when more than one neighbour is valid (matrix_dilate_zero)."""
    n = _shifted_8(x)
    cnt = (n[0] > 0).to(x.dtype)
    s = torch.where(n[0] > 0, n[0], 0.0)
    for v in n[1:]:
        cnt = cnt + (v > 0).to(x.dtype)
        s = s + torch.where(v > 0, v, 0.0)
    fill = torch.where(cnt > 1, s / torch.clamp_min(cnt, 1), 0.0)
    out = torch.where(x == 0, fill, x)
    return torch.where(_interior(x), out, x)


def erode_zero(x: torch.Tensor) -> torch.Tensor:
    """Zero any pixel with a zero 8-neighbour; the border is zeroed
    (matrix_erode_zero)."""
    any_zero = torch.zeros_like(x, dtype=torch.bool)
    for v in _shifted_8(x):
        any_zero |= v == 0
    out = torch.where(any_zero, 0.0, x)
    return torch.where(_interior(x), out, 0.0)


def _edge_pad(x: torch.Tensor, r: int) -> torch.Tensor:
    return F.pad(x[None, None], (r, r, r, r), mode="replicate")[0, 0]


def median_filter(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """ksize x ksize median, border replicate (cv::medianBlur semantics)."""
    if ksize % 2 != 1 or ksize < 3:
        raise ValueError(f"ksize must be odd and >= 3, got {ksize}")
    r = ksize // 2
    p = _edge_pad(x, r)
    H, W = x.shape
    stack = torch.stack([p[dy : dy + H, dx : dx + W] for dy in range(ksize) for dx in range(ksize)])
    return torch.sort(stack, dim=0).values[(ksize * ksize) // 2]


def sobel(x: torch.Tensor, axis: int) -> torch.Tensor:
    """3x3 Sobel derivative, border replicate; axis 0 = d/dx, 1 = d/dy."""
    p = _edge_pad(x, 1)
    H, W = x.shape

    def v(dy, dx):
        return p[dy : dy + H, dx : dx + W]

    if axis == 0:
        return (v(0, 2) - v(0, 0)) + 2 * (v(1, 2) - v(1, 0)) + (v(2, 2) - v(2, 0))
    return (v(2, 0) - v(0, 0)) + 2 * (v(2, 1) - v(0, 1)) + (v(2, 2) - v(0, 2))
