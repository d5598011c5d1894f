"""Image sampling: bilinear / bicubic sampling, homography warp, resize.

Counterpart of wass_tpu/ops/sampling.py.  Images are (H, W) float
tensors; coordinates are (x, y) with (0, 0) at the centre of the top-left
pixel (OpenCV convention); out-of-bounds samples return `fill`.  The port
warps directly (one gather per tap); the JAX package's two-pass warp
exists only to avoid gathers on a TPU.
"""

from __future__ import annotations

import torch


def _gather2d(img: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Clamped integer gather from an (H, W) image."""
    H, W = img.shape
    yi = yi.clamp(0, H - 1)
    xi = xi.clamp(0, W - 1)
    return img.reshape(-1)[(yi * W + xi).reshape(-1)].reshape(yi.shape)


def _valid(x: torch.Tensor, y: torch.Tensor, H: int, W: int) -> torch.Tensor:
    return (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    H, W = img.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    v00 = _gather2d(img, y0i, x0i)
    v01 = _gather2d(img, y0i, x0i + 1)
    v10 = _gather2d(img, y0i + 1, x0i)
    v11 = _gather2d(img, y0i + 1, x0i + 1)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    out = top * (1 - fy) + bot * fy
    return torch.where(_valid(x, y, H, W), out, fill)


def _cubic_kernel_weights(f: torch.Tensor, a: float = -0.75):
    """Weights of the samples at offsets (-1, 0, 1, 2) around f in [0, 1)."""

    def k(x):
        ax = x.abs()
        ax2 = ax * ax
        ax3 = ax2 * ax
        return torch.where(
            ax <= 1.0,
            (a + 2) * ax3 - (a + 3) * ax2 + 1,
            torch.where(ax < 2.0, a * ax3 - 5 * a * ax2 + 8 * a * ax - 4 * a, 0.0),
        )

    return k(1.0 + f), k(f), k(1.0 - f), k(2.0 - f)


def bicubic_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """Bicubic (a = -0.75, OpenCV's) sampling at float coordinates."""
    H, W = img.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = _cubic_kernel_weights(x - x0)
    wy = _cubic_kernel_weights(y - y0)
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    out = torch.zeros(torch.broadcast_shapes(x.shape, y.shape), dtype=img.dtype, device=img.device)
    for j in range(4):
        row = torch.zeros_like(out)
        for i in range(4):
            row = row + wx[i] * _gather2d(img, y0i + j - 1, x0i + i - 1)
        out = out + wy[j] * row
    return torch.where(_valid(x, y, H, W), out, fill)


def warp_homography(
    img: torch.Tensor, Hm: torch.Tensor, out_shape, interp: str = "linear", fill: float = 0.0
) -> torch.Tensor:
    """out(u, v) = img(Hm^-1 (u, v)) (cv::warpPerspective: Hm maps source
    to destination)."""
    Hi = torch.linalg.inv(Hm)
    h, w = out_shape
    u = torch.arange(w, dtype=img.dtype, device=img.device)
    v = torch.arange(h, dtype=img.dtype, device=img.device)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    ww = Hi[2, 0] * uu + Hi[2, 1] * vv + Hi[2, 2]
    ww = torch.where(ww.abs() > 1e-20, ww, 1e-20)
    sx = (Hi[0, 0] * uu + Hi[0, 1] * vv + Hi[0, 2]) / ww
    sy = (Hi[1, 0] * uu + Hi[1, 1] * vv + Hi[1, 2]) / ww
    sampler = bilinear_sample if interp == "linear" else bicubic_sample
    return sampler(img, sx, sy, fill=fill)


def resize(img: torch.Tensor, out_shape, interp: str = "cubic", fill: float = 0.0) -> torch.Tensor:
    """cv::resize-compatible resampling: src = (dst + 0.5) * scale - 0.5;
    interp "nearest" | "linear" | "cubic"."""
    H, W = img.shape
    h, w = out_shape
    xs = (torch.arange(w, dtype=torch.float32, device=img.device) + 0.5) * (W / w) - 0.5
    ys = (torch.arange(h, dtype=torch.float32, device=img.device) + 0.5) * (H / h) - 0.5
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    if interp == "nearest":
        xi = torch.floor(xx + 0.5).to(torch.int64).clamp(0, W - 1)
        yi = torch.floor(yy + 0.5).to(torch.int64).clamp(0, H - 1)
        return _gather2d(img, yi, xi)
    xx = xx.clamp(0.0, W - 1.0).to(img.dtype)
    yy = yy.clamp(0.0, H - 1.0).to(img.dtype)
    sampler = bilinear_sample if interp == "linear" else bicubic_sample
    return sampler(img, xx, yy, fill=fill)
