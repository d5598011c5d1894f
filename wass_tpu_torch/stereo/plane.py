"""Mean-sea-plane estimation: RANSAC + weighted least-squares refinement.

Counterpart of wass_tpu/stereo/plane.py (PovMesh::ransac_find_plane /
crop_plane / refine_plane): all hypotheses are drawn and scored in one
batched pass.  The pixel picks come from a torch.Generator (the
reference's jax.random draws cannot be reproduced), or are passed in as
`uv` so that a test can feed both packages the same picks.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from wass_tpu_torch.device import to_device
from wass_tpu_torch.instrument import host_read


class PlaneFit(NamedTuple):
    plane: torch.Tensor  # (4,) a, b, c, d with ||n|| = 1, c >= 0
    n_inliers: torch.Tensor
    ok: torch.Tensor  # bool: inliers >= 10% of the valid (sampled) points


def plane_distance(plane: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    return (pts[..., 0] * plane[0] + pts[..., 1] * plane[1] + pts[..., 2] * plane[2] + plane[3]).abs()


def draw_pixels(rounds: int, height: int, width: int, seed: int) -> torch.Tensor:
    """(rounds, 3, 2) int64 pixel picks [x, y] from a seeded CPU generator
    (the same picks on every device)."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randint(0, width, (rounds, 3), generator=gen)
    y = torch.randint(0, height, (rounds, 3), generator=gen)
    return torch.stack([x, y], dim=-1)


def ransac_find_plane(
    points: torch.Tensor,
    valid: torch.Tensor,
    rounds: int = 400,
    distance_threshold: float = 1.0,
    seed: int = 0,
    uv: Optional[torch.Tensor] = None,
) -> PlaneFit:
    """Plane through 3 random valid pixels' points (at least 1% of the image
    height apart), normal toward the camera (+z), scored by the inliers
    within distance_threshold on a strided sample of the grid."""
    H, W, _ = points.shape
    mindist = H * 0.01
    if uv is None:
        uv = draw_pixels(rounds, H, W, seed)
    uv = to_device(torch.as_tensor(uv), points.device).to(torch.int64)

    npix = H * W
    stride = 4 if npix > (1 << 21) else (2 if npix > (1 << 20) else 1)
    pts_s = points[::stride, ::stride].reshape(-1, 3)
    valid_s = valid[::stride, ::stride].reshape(-1)

    px, py = uv[..., 0], uv[..., 1]  # (rounds, 3)
    uvf = uv.to(torch.float32)

    def far(i, j):
        d = uvf[:, i] - uvf[:, j]
        return torch.hypot(d[:, 0], d[:, 1]) >= mindist

    ok3 = valid[py[:, 0], px[:, 0]] & valid[py[:, 1], px[:, 1]] & valid[py[:, 2], px[:, 2]]
    p1 = points[py[:, 0], px[:, 0]]
    p2 = points[py[:, 1], px[:, 1]]
    p3 = points[py[:, 2], px[:, 2]]
    n = torch.linalg.cross(p2 - p1, p3 - p1)
    norm = torch.linalg.norm(n, dim=-1)
    n = n / torch.clamp_min(norm, 1e-20)[:, None]
    n = torch.where(n[:, 2:3] < 0, -n, n)
    d = -(n * p1).sum(-1)
    good = far(0, 1) & far(1, 2) & far(0, 2) & ok3 & (norm > 1e-12)
    planes = torch.cat([n, d[:, None]], dim=-1)

    # One float32 pass scores every hypothesis (TF32 is off, device.py).
    dist = (pts_s @ planes[:, :3].T + planes[None, :, 3]).abs()
    counts = ((dist < distance_threshold) & valid_s[:, None]).sum(0)
    counts = torch.where(good, counts, 0)
    # The first best hypothesis, as argmax; a 0-dim tensor index would be a
    # host read, so index_select picks it.
    best_count, best = torch.max(counts, 0)
    n_valid = valid_s.sum()
    return PlaneFit(planes.index_select(0, best.reshape(1))[0], best_count, best_count >= n_valid // 10)


def crop_plane(plane: torch.Tensor, points: torch.Tensor, valid: torch.Tensor, threshold: float) -> torch.Tensor:
    """Invalidate points farther than threshold from the plane."""
    return valid & (plane_distance(plane, points) < threshold)


def refine_plane(
    points: torch.Tensor,
    valid: torch.Tensor,
    max_distance: float = 70.0,
    weight_by_distance: bool = True,
) -> torch.Tensor:
    """Weighted LLS plane: camera-distance weights, weighted centroid and
    covariance, normal = smallest eigenvector, flipped toward the camera."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    dist = torch.sqrt(x * x + y * y + z * z)
    m = valid & (dist < max_distance)
    w = torch.where(m, dist if weight_by_distance else torch.ones_like(dist), 0.0)
    wsum = torch.clamp_min(w.sum(), 1e-20)
    centroid = torch.einsum("...c,...->c", points, w) / wsum
    diff = torch.where(m[..., None], points - centroid, 0.0)
    A = torch.einsum("...i,...j,...->ij", diff, diff, w)
    # The 3x3 eigenproblem runs on the host (LAPACK), not worth a device
    # solver: the frame's one host read on the dispatching thread (the
    # plane parity with the reference rests on these float bits).
    _evals, evecs = torch.linalg.eigh(host_read(A, "plane.read"))
    n = to_device(evecs[:, 0], points.device)
    n = n / torch.clamp_min(torch.linalg.norm(n), 1e-20)
    n = torch.where(n[2] < 0, -n, n)
    d = -(n * centroid).sum()
    return torch.cat([n, d[None]])
