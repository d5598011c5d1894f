"""Two-view linear least-squares triangulation, batched.

Counterpart of wass_tpu/core/triangulate.py: the reference's normal
equations (triangulate.hpp) built as elementwise math with a closed-form
symmetric 3x3 solve.  Camera 0 at the origin, x1 = R x0 + T; p and q are
normalized coordinates in cameras 0 and 1.
"""

from __future__ import annotations

import torch


def triangulate_normalized(p: torch.Tensor, q: torch.Tensor, R: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """(..., 2) x 2 normalized correspondences -> (..., 3) cam0 points."""
    T = T.reshape(3)
    px, py = p[..., 0], p[..., 1]
    qx, qy = q[..., 0], q[..., 1]

    a20 = qx * R[2, 0] - R[0, 0]
    a21 = qx * R[2, 1] - R[0, 1]
    a22 = qx * R[2, 2] - R[0, 2]
    a30 = qy * R[2, 0] - R[1, 0]
    a31 = qy * R[2, 1] - R[1, 1]
    a32 = qy * R[2, 2] - R[1, 2]
    b2 = T[0] - T[2] * qx
    b3 = T[1] - T[2] * qy

    A00 = a20 * a20 + a30 * a30 + 1.0
    A01 = a20 * a21 + a30 * a31
    A02 = a20 * a22 + a30 * a32 - px
    A11 = a21 * a21 + a31 * a31 + 1.0
    A12 = a21 * a22 + a31 * a32 - py
    A22 = a22 * a22 + a32 * a32 + px * px + py * py

    b0 = a20 * b2 + a30 * b3
    b1 = a21 * b2 + a31 * b3
    bb2 = a22 * b2 + a32 * b3

    c00 = A11 * A22 - A12 * A12
    c01 = A02 * A12 - A01 * A22
    c02 = A01 * A12 - A02 * A11
    c11 = A00 * A22 - A02 * A02
    c12 = A01 * A02 - A00 * A12
    c22 = A00 * A11 - A01 * A01
    det = A00 * c00 + A01 * c01 + A02 * c02
    inv_det = torch.where(det.abs() > 1e-30, 1.0 / det, 0.0)
    return torch.stack(
        [
            (c00 * b0 + c01 * b1 + c02 * bb2) * inv_det,
            (c01 * b0 + c11 * b1 + c12 * bb2) * inv_det,
            (c02 * b0 + c12 * b1 + c22 * bb2) * inv_det,
        ],
        dim=-1,
    )
