"""Polarimetric sea-surface analysis over the elevation grid.

Counterpart of wass_tpu/post/polarimetric.py (the computational core of
the wasspost `polarimetric_setup` command, wasspost.py:634-805): each
frame's grid points are projected into the camera (float64 on the host),
the Stokes components sampled there on the device, the viewing rays and
incidence angles computed against the wave normals, and the sequence
averages accumulated (Stokes, normals, elevation, validity) on the host
in float64.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from wass_tpu_torch.device import resolve_device
from wass_tpu_torch.ops.sampling import bilinear_sample
from wass_tpu_torch.post.geometry import compute_slope_and_normals
from wass_tpu_torch.post.radiance import project_grid


@dataclasses.dataclass
class PolarimetricAccumulator:
    S_avg: np.ndarray  # (H, W, 3) averaged Stokes
    N_avg: np.ndarray  # (H, W, 3) averaged normals
    Z_avg: np.ndarray  # (H, W)
    incidence_avg: np.ndarray  # (H, W) radians
    valid: np.ndarray  # (H, W) accumulation counts
    n_frames: int = 0

    @staticmethod
    def zeros(shape) -> "PolarimetricAccumulator":
        H, W = shape
        return PolarimetricAccumulator(S_avg=np.zeros((H, W, 3)), N_avg=np.zeros((H, W, 3)), Z_avg=np.zeros((H, W)),
                                       incidence_avg=np.zeros((H, W)), valid=np.zeros((H, W)))

    def finalize(self):
        n = np.maximum(self.valid, 1)
        return (
            self.S_avg / n[..., None],
            self.N_avg / np.maximum(self.n_frames, 1),
            self.Z_avg / np.maximum(self.n_frames, 1),
            self.incidence_avg / n,
        )


def incidence_angles(Z, XX, YY, cam_origin_grid: np.ndarray):
    """Incidence angle between the camera ray and the wave normal at each
    grid point (wasspost.py:697-760), with the normals and unit rays."""
    _, normals = compute_slope_and_normals(XX, YY, Z)
    rays = np.dstack([XX - cam_origin_grid[0], YY - cam_origin_grid[1], Z - cam_origin_grid[2]])
    rays = rays / np.linalg.norm(rays, axis=-1, keepdims=True)
    cosang = np.clip(-np.sum(rays * normals, axis=-1), -1.0, 1.0)
    return np.arccos(cosang), normals, rays


def accumulate_frame(acc: PolarimetricAccumulator, Z: np.ndarray, XX: np.ndarray, YY: np.ndarray, S0: np.ndarray,
                     S1: np.ndarray, S2: np.ndarray, Pplane: np.ndarray, cam_origin_grid: np.ndarray,
                     device="cuda") -> PolarimetricAccumulator:
    """Add one frame's grid-sampled Stokes components and geometry."""
    dev = resolve_device(device)
    Ih, Iw = S0.shape
    mapx, mapy = project_grid(Z, XX, YY, Pplane, (Iw, Ih))  # the sampling maps (wasspost.py:666-700)
    inb = (mapx >= 0) & (mapx < Iw - 1) & (mapy >= 0) & (mapy < Ih - 1) & np.isfinite(Z)
    mx = torch.as_tensor(np.nan_to_num(mapx), device=dev)
    my = torch.as_tensor(np.nan_to_num(mapy), device=dev)
    S = np.dstack([bilinear_sample(torch.as_tensor(np.asarray(img, np.float32), device=dev), mx, my).cpu().numpy()
                   for img in (S0, S1, S2)])
    ang, normals, _ = incidence_angles(np.nan_to_num(Z), XX, YY, cam_origin_grid)
    w = inb.astype(float)
    acc.S_avg += S * w[..., None]
    acc.N_avg += np.nan_to_num(normals)
    acc.Z_avg += np.nan_to_num(Z)
    acc.incidence_avg += ang * w
    acc.valid += w
    acc.n_frames += 1
    return acc
