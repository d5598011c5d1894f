"""Reference copy of wass_tpu_torch/core/geometry.py (rt_from_plane, homogeneous_transform), frozen when the
benchmark was written: plain PyTorch and NumPy, importing nothing of the
program; where the program launches a CUDA kernel this copy runs the
kernel's plain version.  The original's notes follow.

Batched 3D geometry primitives on tensors.

Counterpart of wass_tpu/core/geometry.py: the rotation parametrisations of
the match and calibration stages, and the plane-frame transform, 3x3
solve and homography of the dense path.  Everything is batched over
leading dimensions and differentiable under torch.func.
"""

from __future__ import annotations

import torch

from .precision import tf32


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
    Tinv = torch.einsum("...ij,...j->...i", tf32(Rinv), tf32(-T))
    return R, T, Rinv, Tinv


def homogeneous_transform(Hm: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a 3x3 homography to (..., 2) points with perspective divide."""
    x, y = pts[..., 0], pts[..., 1]
    w = Hm[..., 2, 0] * x + Hm[..., 2, 1] * y + Hm[..., 2, 2]
    u = Hm[..., 0, 0] * x + Hm[..., 0, 1] * y + Hm[..., 0, 2]
    v = Hm[..., 1, 0] * x + Hm[..., 1, 1] * y + Hm[..., 1, 2]
    w = torch.where(w.abs() > 1e-20, w, 1e-20)
    return torch.stack([u / w, v / w], dim=-1)
