"""Batched 3D geometry primitives on tensors.

Counterpart of the parts of wass_tpu/core/geometry.py the dense path uses.
"""

from __future__ import annotations

import torch


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True), eps)


def rt_from_plane(plane: torch.Tensor):
    """Camera-frame -> sea-plane-frame transform from plane coefficients
    (a, b, c, d), the closed form of PovMesh::RT_from_plane: R maps the
    normal onto +z, T = (0, 0, d).  Returns (R, T, Rinv, Tinv)."""
    a, b, c, d = plane[..., 0], plane[..., 1], plane[..., 2], plane[..., 3]
    q = (1.0 - c) / (a * a + b * b)
    R = torch.stack(
        [
            torch.stack([1.0 - a * a * q, -a * b * q, -a], dim=-1),
            torch.stack([-a * b * q, 1.0 - b * b * q, -b], dim=-1),
            torch.stack([a, b, c], dim=-1),
        ],
        dim=-2,
    )
    zero = torch.zeros_like(d)
    T = torch.stack([zero, zero, d], dim=-1)
    Rinv = R.transpose(-1, -2)
    Tinv = torch.einsum("...ij,...j->...i", Rinv, -T)
    return R, T, Rinv, Tinv


def solve3x3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 solve via the adjugate (0 where singular)."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c10 + a02 * c20
    inv_det = torch.where(det.abs() > 1e-30, 1.0 / det, 0.0)
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [
            (c00 * b0 + c01 * b1 + c02 * b2) * inv_det,
            (c10 * b0 + c11 * b1 + c12 * b2) * inv_det,
            (c20 * b0 + c21 * b1 + c22 * b2) * inv_det,
        ],
        dim=-1,
    )


def homogeneous_transform(Hm: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a 3x3 homography to (..., 2) points with perspective divide."""
    x, y = pts[..., 0], pts[..., 1]
    w = Hm[..., 2, 0] * x + Hm[..., 2, 1] * y + Hm[..., 2, 2]
    u = Hm[..., 0, 0] * x + Hm[..., 0, 1] * y + Hm[..., 0, 2]
    v = Hm[..., 1, 0] * x + Hm[..., 1, 1] * y + Hm[..., 1, 2]
    w = torch.where(w.abs() > 1e-20, w, 1e-20)
    return torch.stack([u / w, v / w], dim=-1)
