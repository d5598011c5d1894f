"""Surface geometry analytics: slopes and normals, occlusion masks and the
visibility of a frame slab toward a camera.

Counterpart of wass_tpu/post/geometry.py (itself after the reference's
postproc/wasspost/geometry.py:5-100 and wasspost.py:502-621).  The ray
directions, the normals, the incidence angles and the march of a slab are
one fused kernel (`visibility_kernels.visibility_batch`,
csrc/visibility.cu); `compute_occlusion_mask`, whose rays come from the
caller, runs the march alone (`visibility_kernels.march`).
"""

from __future__ import annotations

import numpy as np
import torch

from wass_tpu_torch.device import resolve_device
from wass_tpu_torch.post.visibility_kernels import march, ray_steps, view_rays, visibility_batch  # noqa: F401


def compute_slope_and_normals(XX: np.ndarray, YY: np.ndarray, ZZ: np.ndarray):
    """np.gradient slopes and upward unit normals (host float64)."""
    dx = XX[0, 1] - XX[0, 0]
    dy = YY[1, 0] - YY[0, 0]
    slope_y, slope_x = np.gradient(ZZ, dy, dx)
    slope = np.dstack([slope_x, slope_y])
    normals = np.dstack([slope_x, slope_y, -np.ones_like(ZZ)])
    normals = -normals / np.linalg.norm(normals, axis=-1, keepdims=True)
    return slope, normals


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


def visibility_device_batch(Z: torch.Tensor, cam: torch.Tensor, XX: torch.Tensor, YY: torch.Tensor,
                            max_steps: int):
    """Z (B, H, W) heights, cam (3,), XX/YY (H, W), all float32 in cell
    units on one device -> (occ (B, H, W) bool, incidence degrees (B, H, W)
    float32); incidence >= 88 degrees counts as occluded.  One fused
    kernel on the card (`visibility_kernels.visibility_batch`)."""
    return visibility_batch(Z, cam, XX, YY, max_steps)


def compute_visibility_batch(ZZ_slab: np.ndarray, XX: np.ndarray, YY: np.ndarray, cam_center: np.ndarray,
                             dx: float, device="cuda"):
    """Occlusion masks and incidence angles of a slab of frames.  ZZ_slab
    (B, H, W), cam_center and XX/YY in meters, scaled to cell units as the
    reference does (wasspost.py:581-583).  Returns (occ uint8 (B, H, W),
    inc float32 (B, H, W)) as numpy arrays."""
    dev = resolve_device(device)
    inv = 1.0 / dx

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)

    occ, inc = visibility_device_batch(put(ZZ_slab * inv), put(np.asarray(cam_center, np.float64) * inv),
                                       put(XX * inv), put(YY * inv), int(2 * max(ZZ_slab.shape[1:])))
    return occ.to(torch.uint8).cpu().numpy(), inc.cpu().numpy()
