"""Multiscale feature detection and descriptors, fixed shape and batched.

Counterpart of wass_tpu/match/features.py (the WASS FeatureSet, KAZE plus
area-stratified subsampling), with the same design:

* scale space: 8 Gaussian blurs at full resolution (separable, edge
  padded), the scale-normalized determinant of the Hessian;
* 3x3x3 non-max suppression over (scale, y, x);
* one winner per grid cell, then an area-stratified top-k that takes the
  cells round-robin over area_subdivision^2 areas;
* a quadratic subpixel offset on the response at the detected scale;
* upright SURF-style 64-d descriptors from bilinear gradient samples.

Always returns max_features slots and a validity mask.  The separable
blur is stereo/cost.py's gauss_blur (the same function as the JAX
package's _gauss_blur): shifted multiply-adds summed pairwise, bit-equal
to XLA's convolution for the 5-tap sigma 0.8 kernel, within float32
rounding for the wider scale-space kernels.  Sorts are stable, as
jnp.argsort is.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from wass_tpu_torch.stereo.cost import gauss_blur


class FeatureSet(NamedTuple):
    xy: torch.Tensor  # (K, 2) pixel coords
    scale: torch.Tensor  # (K,) detection scale (sigma, px)
    angle: torch.Tensor  # (K,) orientation in radians, [0, 2 pi)
    response: torch.Tensor  # (K,)
    desc: torch.Tensor  # (K, 64) L2-normalized descriptors
    valid: torch.Tensor  # (K,) bool


def _gradient(a: torch.Tensor, dim: int) -> torch.Tensor:
    """jnp.gradient along dim: one-sided differences at the edges, central
    differences times 0.5 inside."""
    n = a.shape[dim]
    upper = a.narrow(dim, 1, 1) - a.narrow(dim, 0, 1)
    inner = (a.narrow(dim, 2, n - 2) - a.narrow(dim, 0, n - 2)) * 0.5
    lower = a.narrow(dim, n - 1, 1) - a.narrow(dim, n - 2, 1)
    return torch.cat([upper, inner, lower], dim)


def _hessian_response(smoothed: torch.Tensor, sigma: float) -> torch.Tensor:
    """Scale-normalized determinant of the Hessian, sigma^4 |H|."""
    dy, dx = _gradient(smoothed, 0), _gradient(smoothed, 1)
    dyy, dyx = _gradient(dy, 0), _gradient(dy, 1)
    dxy, dxx = _gradient(dx, 0), _gradient(dx, 1)
    return (sigma**4) * (dxx * dyy - dxy * dyx)


def build_scale_space(img: torch.Tensor, n_scales: int = 8, sigma0: float = 1.6, step: float = 1.45):
    sigmas = [sigma0 * step**i for i in range(n_scales)]
    smoothed = [gauss_blur(img, s) for s in sigmas]
    responses = torch.stack([_hessian_response(sm, s) for sm, s in zip(smoothed, sigmas)])
    return torch.stack(smoothed), responses, torch.tensor(sigmas, dtype=torch.float32, device=img.device)


def _nms3d(resp: torch.Tensor) -> torch.Tensor:
    """3x3x3 non-max suppression over (S, H, W): a sample is kept when it is
    >= every neighbour that exists (max pooling pads with -inf)."""
    return resp >= F.max_pool3d(resp[None, None], 3, stride=1, padding=1)[0, 0]


def detect_features(img: torch.Tensor, max_features: int = 2000, hessian_threshold: float = 1e-4,
                    n_scales: int = 8, grid_cell: int = 12, area_subdivision: int = 5,
                    border_frac: float = 1.0 / 30.0) -> FeatureSet:
    """Up to max_features features of an (H, W) image (0-255 levels).

    grid_cell plays FEATURE_MIN_DISTANCE (one winner per grid_cell x
    grid_cell block); area_subdivision is AREA_SUBDIVISION."""
    H, W = img.shape
    dev = img.device
    img = img.to(torch.float32) / 255.0
    smoothed, responses, sigmas = build_scale_space(img, n_scales)

    masked = torch.where(_nms3d(responses), responses, -torch.inf)
    resp_best, scale_idx = masked.max(dim=0)

    border = max(W * border_frac, 2.0)
    yy = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    in_border = (xx > border) & (xx < W - border) & (yy > border) & (yy < H - border)
    resp_masked = torch.where((resp_best > hessian_threshold) & in_border, resp_best, -torch.inf)

    # --- grid suppression: the best candidate per cell ---------------------
    gh, gw = -(-H // grid_cell), -(-W // grid_cell)
    padded = torch.full((gh * grid_cell, gw * grid_cell), -torch.inf, device=dev)
    padded[:H, :W] = resp_masked
    cells = padded.reshape(gh, grid_cell, gw, grid_cell).permute(0, 2, 1, 3).reshape(gh, gw, -1)
    cell_resp, cell_best = cells.max(dim=-1)
    cell_y = cell_best // grid_cell + torch.arange(gh, device=dev)[:, None] * grid_cell
    cell_x = cell_best % grid_cell + torch.arange(gw, device=dev)[None, :] * grid_cell

    # --- area-stratified top-k: rank cells within each area by response,
    # then order on (rank in area, position in the response order) -----------
    n_areas = area_subdivision
    area_id = (cell_y * n_areas // max(H, 1)) * n_areas + (cell_x * n_areas // max(W, 1))
    flat_resp = cell_resp.reshape(-1)
    flat_area = area_id.reshape(-1)
    order = torch.argsort(-flat_resp, stable=True)
    sorted_area = flat_area[order]
    onehot = F.one_hot(sorted_area, n_areas * n_areas).to(torch.int32)
    rank_in_area = (torch.cumsum(onehot, dim=0) - 1).gather(1, sorted_area[:, None])[:, 0]
    sorted_resp = flat_resp[order]
    key = torch.where(torch.isfinite(sorted_resp), rank_in_area, torch.iinfo(torch.int32).max)
    selection = order[torch.argsort(key, stable=True)][:max_features]

    sel_y = cell_y.reshape(-1)[selection].clamp(0, H - 1)
    sel_x = cell_x.reshape(-1)[selection].clamp(0, W - 1)
    sel_resp = flat_resp[selection]
    valid = torch.isfinite(sel_resp)
    sel_sidx = scale_idx[sel_y, sel_x]
    sel_scale = sigmas[sel_sidx]

    # --- subpixel: a quadratic through five response taps at that scale ----
    def rtap(dy, dx):
        return responses[sel_sidx, (sel_y + dy).clamp(0, H - 1), (sel_x + dx).clamp(0, W - 1)]

    c = rtap(0, 0)
    dxm, dxp = rtap(0, -1), rtap(0, 1)
    dym, dyp = rtap(-1, 0), rtap(1, 0)
    ox = ((dxm - dxp) / (2 * (dxm + dxp - 2 * c).abs() + 1e-12)).clamp(-0.5, 0.5)
    oy = ((dym - dyp) / (2 * (dym + dyp - 2 * c).abs() + 1e-12)).clamp(-0.5, 0.5)
    xy = torch.stack([sel_x + ox, sel_y + oy], dim=-1)

    angle, desc = _describe(smoothed, sigmas, xy, sel_sidx)
    return FeatureSet(xy=xy.to(torch.float32), scale=sel_scale, angle=angle,
                      response=torch.where(valid, sel_resp, 0.0), desc=desc, valid=valid)


def _describe(smoothed: torch.Tensor, sigmas: torch.Tensor, xy: torch.Tensor, sidx: torch.Tensor):
    """Upright SURF-style 64-d descriptors and gradient orientations: a
    16x16 grid spanning 20 sigma around each keypoint, sampled from the
    keypoint's smoothed plane; 4x4 subregions x (sum dx, sum |dx|, sum dy,
    sum |dy|), Gaussian-weighted, L2-normalized."""
    S, H, W = smoothed.shape
    G, span = 16, 20.0
    dev = smoothed.device
    offs = (torch.arange(G, dtype=torch.float32, device=dev) - (G - 1) / 2) / G * span  # sigma units
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    gw = torch.exp(-0.5 * ((ox / (span / 2)) ** 2 + (oy / (span / 2)) ** 2) * 4.0)

    # The plane is picked inside the gather (row offset si * H into the
    # (S * H, W) stack), rows clipped to the plane first.
    flat = smoothed.reshape(S * H, W)
    base = (sidx * H)[:, None, None]

    def plane_bilinear(sx, sy):
        x0 = torch.floor(sx)
        y0 = torch.floor(sy)
        fx = sx - x0
        fy = sy - y0
        x0i = x0.to(torch.int64)
        y0i = y0.to(torch.int64)

        def g(yi, xi):
            return flat[yi.clamp(0, H - 1) + base, xi.clamp(0, W - 1)]

        top = g(y0i, x0i) * (1 - fx) + g(y0i, x0i + 1) * fx
        bot = g(y0i + 1, x0i) * (1 - fx) + g(y0i + 1, x0i + 1) * fx
        out = top * (1 - fy) + bot * fy
        inside = (sx >= 0) & (sx <= W - 1) & (sy >= 0) & (sy <= H - 1)
        return torch.where(inside, out, 0.0)

    sig = sigmas[sidx][:, None, None]
    sx = xy[:, 0, None, None] + ox * sig
    sy = xy[:, 1, None, None] + oy * sig
    eps = torch.clamp_min(sig, 1.0)
    dx = (plane_bilinear(sx + eps, sy) - plane_bilinear(sx - eps, sy)) * gw
    dy = (plane_bilinear(sx, sy + eps) - plane_bilinear(sx, sy - eps)) * gw
    K = xy.shape[0]
    ang = torch.atan2(dy.reshape(K, -1).sum(-1), dx.reshape(K, -1).sum(-1))

    def sub(a):
        return a.reshape(K, 4, 4, 4, 4).permute(0, 1, 3, 2, 4).reshape(K, 4, 4, 16)

    dxs, dys = sub(dx), sub(dy)
    d = torch.stack([dxs.sum(-1), dxs.abs().sum(-1), dys.sum(-1), dys.abs().sum(-1)], dim=-1).reshape(K, 64)
    d = d / torch.clamp_min(torch.linalg.norm(d, dim=-1, keepdim=True), 1e-12)
    # Wrapped to [0, 2 pi) like the reference (FeatureSet.cpp:293-296).
    return torch.remainder(ang, 2 * math.pi), d
