"""Batched 3D geometry primitives on tensors.

Counterpart of wass_tpu/core/geometry.py: the rotation parametrisations of
the match and calibration stages, and the plane-frame transform, 3x3
solve and homography of the dense path.  Everything is batched over
leading dimensions and differentiable under torch.func.
"""

from __future__ import annotations

import torch


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric cross-product matrix [v]_x, batched over leading dims."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle vector -> rotation matrix (cv::Rodrigues forward).

    R = I + A [r]x + B [r]x^2 with A = sin(t)/t and B = (1-cos(t))/t^2 on
    the unnormalized vector, Taylor series near t = 0 through the
    double-where: the unused branch is evaluated at a safe t, so
    torch.func.jacfwd at the identity (the BA linearization point) gives
    no NaN.  t2 keeps a trailing dimension: under forward-mode AD a
    0-dim tensor combined with a Python scalar gets a float64 tangent."""
    t2 = (rvec * rvec).sum(-1, keepdim=True)
    small = t2 < 1e-10
    safe_t2 = torch.where(small, 1.0, t2)
    t = torch.sqrt(safe_t2)
    A = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    B = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / safe_t2)
    K = skew(rvec)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(K.shape)
    return eye + A[..., None] * K + B[..., None] * (K @ K)


def inv_rodrigues(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle vector (cv::Rodrigues inverse), by the
    quaternion route, stable near theta = 0 and pi."""
    q = rot_to_quat(R)
    w = q[..., 0]
    v = q[..., 1:]
    sin_half = torch.linalg.norm(v, dim=-1)
    half = torch.atan2(sin_half, w)
    big = sin_half > 1e-12
    scale = torch.where(big, 2.0 * half / torch.where(big, sin_half, 1.0), 2.0)
    return v * scale[..., None]


def invert_rt(R: torch.Tensor, T: torch.Tensor):
    """Invert the rigid transform x' = R x + T; T may be (..., 3) or (..., 3, 1)."""
    Rt = R.transpose(-1, -2)
    squeeze = T.shape[-1] == 1
    Tv = T[..., 0] if squeeze else T
    Tinv = -torch.einsum("...ij,...j->...i", Rt, Tv)
    return Rt, (Tinv[..., None] if squeeze else Tinv)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) -> rotation matrix, batched."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1),
        ],
        dim=-2,
    )


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w, x, y, z), w >= 0, batched:
    the four Shepperd candidates, the best-conditioned one selected."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    pivots = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1)
    idx = torch.argmax(pivots, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4 candidates, 4 components)
    q = torch.take_along_dim(cands, idx[..., None, None], dim=-2)[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


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
