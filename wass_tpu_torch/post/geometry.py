"""Surface geometry analytics: slopes and normals, occlusion masks and the
visibility of a frame slab toward a camera.

Counterpart of wass_tpu/post/geometry.py (itself after the reference's
postproc/wasspost/geometry.py:5-100 and wasspost.py:502-621).  The ray
directions, the normals and the incidence angles are computed here in
float32 PyTorch on the device, op by op; the march itself is one kernel
(`visibility_kernels.march`, csrc/visibility.cu), shared by
`compute_occlusion_mask` and `compute_visibility_batch`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from wass_tpu_torch.device import resolve_device
from wass_tpu_torch.post.visibility_kernels import march


def compute_slope_and_normals(XX: np.ndarray, YY: np.ndarray, ZZ: np.ndarray):
    """np.gradient slopes and upward unit normals (host float64)."""
    dx = XX[0, 1] - XX[0, 0]
    dy = YY[1, 0] - YY[0, 0]
    slope_y, slope_x = np.gradient(ZZ, dy, dx)
    slope = np.dstack([slope_x, slope_y])
    normals = np.dstack([slope_x, slope_y, -np.ones_like(ZZ)])
    normals = -normals / np.linalg.norm(normals, axis=-1, keepdims=True)
    return slope, normals


def _norm3(v: torch.Tensor) -> torch.Tensor:
    """|v| over the last axis of size 3, summed in order (as jnp.linalg.norm)."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])[..., None]


def ray_steps(rays: torch.Tensor) -> torch.Tensor:
    """Ray directions scaled so that the larger horizontal component steps
    one cell, flattened to (n, 3)."""
    denom = torch.maximum(rays[..., 0].abs(), rays[..., 1].abs()).clamp(min=1e-12)
    return (rays / denom[..., None]).reshape(-1, 3)


def compute_occlusion_mask(ZZ: np.ndarray, ray_d: np.ndarray, invert_y_axis: bool = False,
                           device="cuda") -> np.ndarray:
    """Occlusion mask (H, W) uint8: 1 where the ray from a surface point
    along ray_d (H, W, 3), upward, meets the surface again."""
    if ray_d.shape != ZZ.shape + (3,):
        raise ValueError(f"ray_d {ray_d.shape} for a grid {ZZ.shape}")
    if not np.nanmin(ray_d[..., 2]) > 0:
        raise ValueError("rays must go upward")
    dev = resolve_device(device)
    rd = np.array(ray_d, np.float64)
    if invert_y_axis:
        rd[..., 1] *= -1
    Z = torch.as_tensor(np.asarray(ZZ, np.float32), device=dev)
    d = ray_steps(torch.as_tensor(rd.astype(np.float32), device=dev))
    occ = march(Z[None], d, Z.max().reshape(1), int(2 * max(ZZ.shape)))
    return occ[0].cpu().numpy()


def _grad(a: torch.Tensor, axis: int) -> torch.Tensor:
    """Central differences along axis, one-sided at the borders (the JAX
    function's np.gradient with unit spacing)."""
    up, dn = torch.roll(a, -1, axis), torch.roll(a, 1, axis)
    out = (up - dn) * 0.5
    n = a.shape[axis]
    first = a.narrow(axis, 1, 1) - a.narrow(axis, 0, 1)
    last = a.narrow(axis, n - 1, 1) - a.narrow(axis, n - 2, 1)
    idx = torch.arange(n, device=a.device).reshape([n if i == axis else 1 for i in range(a.dim())])
    out = torch.where(idx == 0, first, out)
    return torch.where(idx == n - 1, last, out)


def view_rays(Z: torch.Tensor, cam: torch.Tensor, XX: torch.Tensor, YY: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) unit rays from every cell toward the camera (float32,
    cell units), the height difference kept above 1e-3."""
    B, H, W = Z.shape
    rays = torch.stack([(cam[0] - XX).expand(B, H, W), (cam[1] - YY).expand(B, H, W),
                        (cam[2] - Z).clamp(min=1e-3)], dim=-1)
    return rays / _norm3(rays)


def visibility_device_batch(Z: torch.Tensor, cam: torch.Tensor, XX: torch.Tensor, YY: torch.Tensor,
                            max_steps: int):
    """Z (B, H, W) heights, cam (3,), XX/YY (H, W), all float32 in cell
    units on one device -> (occ (B, H, W) bool, incidence degrees (B, H, W)
    float32); incidence >= 88 degrees counts as occluded."""
    maxz = Z.amax(dim=(1, 2))
    rays = view_rays(Z, cam, XX, YY)
    sx = _grad(Z, 2) / (XX[0, 1] - XX[0, 0])
    sy = _grad(Z, 1) / (YY[1, 0] - YY[0, 0])
    normals = torch.stack([sx, sy, -torch.ones_like(Z)], dim=-1)
    normals = -normals / _norm3(normals)
    prod = normals * rays
    cos = (prod[..., 0] + prod[..., 1] + prod[..., 2]).clamp(-1.0, 1.0)
    inc = torch.arccos(cos) * (180.0 / math.pi)
    occ = march(Z.contiguous(), ray_steps(rays), maxz, max_steps)
    return (occ != 0) | (inc >= 88.0), inc


def compute_visibility_batch(ZZ_slab: np.ndarray, XX: np.ndarray, YY: np.ndarray, cam_center: np.ndarray,
                             dx: float, device="cuda"):
    """Occlusion masks and incidence angles of a slab of frames.  ZZ_slab
    (B, H, W), cam_center and XX/YY in meters, scaled to cell units as the
    reference does (wasspost.py:581-583).  Returns (occ uint8 (B, H, W),
    inc float32 (B, H, W)) as numpy arrays."""
    dev = resolve_device(device)
    inv = 1.0 / dx

    def put(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    occ, inc = visibility_device_batch(put(ZZ_slab * inv), put(np.asarray(cam_center, np.float64) * inv),
                                       put(XX * inv), put(YY * inv), int(2 * max(ZZ_slab.shape[1:])))
    return occ.to(torch.uint8).cpu().numpy(), inc.cpu().numpy()
