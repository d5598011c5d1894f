"""Grid-organized point-cloud operations (PovMesh method equivalents).

Counterpart of wass_tpu/stereo/meshops.py: Laplacian smoothing
(PovMesh.cpp:990-1040), rigid cropping (crop, :263-289 via the bbox
semantics) and the two-point distance of `measure`.  Each runs on the
device of its tensors, in float32 as the JAX functions do (without x64
their inputs become float32).
"""

from __future__ import annotations

import torch

from wass_tpu_torch.stereo.dense import fma32


def laplacian_smooth(points: torch.Tensor, valid: torch.Tensor, steps: int = 1) -> torch.Tensor:
    """Validity-aware Laplacian smoothing of an (H, W, 3) point grid: each
    valid point moves to the mean of its valid 4-neighbours
    (PovMesh::laplacian_smooth)."""
    H, W, _ = points.shape
    v = torch.zeros((H + 2, W + 2), dtype=points.dtype, device=points.device)
    v[1:-1, 1:-1] = valid.to(points.dtype)
    for _ in range(steps):
        p = torch.zeros((H + 2, W + 2, 3), dtype=points.dtype, device=points.device)
        p[1:-1, 1:-1] = points
        acc = torch.zeros_like(points)
        cnt = torch.zeros((H, W), dtype=points.dtype, device=points.device)
        for dy, dx in ((0, 1), (2, 1), (1, 0), (1, 2)):
            nv = v[dy:dy + H, dx:dx + W]
            acc = acc + p[dy:dy + H, dx:dx + W] * nv[..., None]
            cnt = cnt + nv
        mean = acc / torch.clamp_min(cnt, 1.0)[..., None]
        points = torch.where((valid & (cnt > 0))[..., None], mean, points)
    return points


def crop_grid(valid: torch.Tensor, top: int, left: int, bottom: int, right: int) -> torch.Tensor:
    """Invalidate everything outside the [top:bottom, left:right] window of
    the grid (PovMesh::crop semantics)."""
    H, W = valid.shape
    yy = torch.arange(H, device=valid.device)[:, None]
    xx = torch.arange(W, device=valid.device)[None, :]
    return valid & (yy >= top) & (yy < bottom) & (xx >= left) & (xx < right)


def measure_distance(p1, p2) -> torch.Tensor:
    """Two-point distance (the wass_stereo --measure workflow,
    wass_stereo.cpp:1934-1973, without the interactive picker), in float32:
    the squares summed in XLA's compiled order, a chain of fused
    multiply-adds (fma32), so the printed digits are the JAX command's."""
    d = torch.as_tensor(p1, dtype=torch.float32) - torch.as_tensor(p2, dtype=torch.float32)
    s = torch.zeros((), dtype=torch.float32)
    for x in d:
        s = fma32(x, x, s)
    return torch.sqrt(s)
