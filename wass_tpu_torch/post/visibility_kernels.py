"""Wrappers of the visibility CUDA kernels and their plain versions.

Counterparts of wass_tpu/post/geometry.py's compiled programs,
csrc/visibility.cu:

* `visibility_batch`: the whole of `_visibility_device_batch` (:94) in one
  fused kernel.  Every cell of every frame of a slab gets its unit ray
  toward the camera, the surface normal from np.gradient's slopes, the
  incidence angle between them, and the ray march: the ray from (x, y, Z)
  along its direction (cell units, the larger horizontal component one
  cell a step) occludes its cell when it meets the surface again (Z >= the
  ray's height) before it leaves the grid or climbs above the frame's
  highest cell; an incidence >= 88 degrees occludes too.
* `march`: the march alone (`_occlusion_device`, :33), on directions the
  caller gives.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version (`visibility_batch_plain`, `march_plain`: the JAX program op by op
in PyTorch) for CPU tensors only.
"""

from __future__ import annotations

import math

import torch

from wass_tpu_torch import _build
from wass_tpu_torch.device import on_cuda
from wass_tpu_torch.instrument import LaunchCounts

LAUNCHES = LaunchCounts({"visibility_batch": 0, "visibility_march": 0})


def _norm3(v: torch.Tensor) -> torch.Tensor:
    """|v| over the last axis of size 3, summed in order (as jnp.linalg.norm)."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])[..., None]


def ray_steps(rays: torch.Tensor) -> torch.Tensor:
    """Ray directions scaled so that the larger horizontal component steps
    one cell, flattened to (n, 3)."""
    denom = torch.maximum(rays[..., 0].abs(), rays[..., 1].abs()).clamp(min=1e-12)
    return (rays / denom[..., None]).reshape(-1, 3)


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


def march_plain(Z: torch.Tensor, d: torch.Tensor, maxz: torch.Tensor, max_steps: int, count_steps: bool = False):
    """The JAX loop's steps over all rays at once, stopping when no ray is
    active (a host read a step).  The bounds are tested on the rounded
    floats, as the kernel does (see csrc/visibility.cu).  With count_steps
    also returns the steps the rays took, summed (the march's work)."""
    B, H, W = Z.shape
    hw = H * W
    n = B * hw
    zflat = Z.reshape(-1)
    px = torch.arange(W, dtype=Z.dtype, device=Z.device).repeat(B * H)
    py = torch.arange(H, dtype=Z.dtype, device=Z.device).repeat_interleave(W).repeat(B)
    pz = zflat.clone()
    fb = torch.arange(n, device=Z.device) // hw
    maxz_r = maxz[fb]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    occ = torch.zeros(n, dtype=torch.bool, device=Z.device)
    active = torch.ones(n, dtype=torch.bool, device=Z.device)
    steps = 0
    for _ in range(max_steps):
        live = int(active.sum())
        if not live:
            break
        steps += live
        px = px + dx
        py = py + dy
        pz = pz + dz
        rx, ry = torch.round(px), torch.round(py)
        active &= (rx >= 0) & (rx < W) & (ry >= 0) & (ry < H) & (pz <= maxz_r)
        xi = torch.where(active, rx, 0.0).long()
        yi = torch.where(active, ry, 0.0).long()
        hit = active & (zflat[fb * hw + yi * W + xi] >= pz)
        occ |= hit
        active &= ~hit
    occ = occ.reshape(B, H, W).to(torch.uint8)
    return (occ, steps) if count_steps else occ


def march(Z: torch.Tensor, d: torch.Tensor, maxz: torch.Tensor, max_steps: int) -> torch.Tensor:
    """Z (B, H, W) float32 heights in cell units, d (B*H*W, 3) float32 ray
    steps, maxz (B,) float32 each frame's highest cell -> (B, H, W) uint8,
    1 where the cell's ray meets the surface within max_steps steps."""
    if Z.dim() != 3 or d.shape != (Z.numel(), 3) or maxz.shape != (Z.shape[0],):
        raise ValueError(f"march: Z {tuple(Z.shape)}, d {tuple(d.shape)}, maxz {tuple(maxz.shape)}")
    if not (Z.dtype == d.dtype == maxz.dtype == torch.float32):
        raise ValueError("march: Z, d and maxz must be float32")
    if not on_cuda(Z, d, maxz):
        return march_plain(Z, d, maxz, max_steps)
    Z, d, maxz = Z.contiguous(), d.contiguous(), maxz.contiguous()
    B, H, W = Z.shape
    occ = torch.empty((B, H, W), dtype=torch.uint8, device=Z.device)
    counter = torch.empty(1, dtype=torch.int64, device=Z.device)  # the ray queue
    _build.launch("wass_visibility_march", "visibility_march kernel", Z.device,
                  Z.data_ptr(), d.data_ptr(), maxz.data_ptr(), occ.data_ptr(), counter.data_ptr(),
                  B, H, W, int(max_steps))
    LAUNCHES.add("visibility_march")
    return occ


def visibility_batch_plain(Z: torch.Tensor, cam: torch.Tensor, XX: torch.Tensor, YY: torch.Tensor, max_steps: int):
    """The JAX program op by op: (occ (B, H, W) bool, incidence degrees
    (B, H, W) float32)."""
    maxz = Z.amax(dim=(1, 2))
    rays = view_rays(Z, cam, XX, YY)
    sx = _grad(Z, 2) / (XX[0, 1] - XX[0, 0])
    sy = _grad(Z, 1) / (YY[1, 0] - YY[0, 0])
    normals = torch.stack([sx, sy, -torch.ones_like(Z)], dim=-1)
    normals = -normals / _norm3(normals)
    prod = normals * rays
    cos = (prod[..., 0] + prod[..., 1] + prod[..., 2]).clamp(-1.0, 1.0)
    inc = torch.arccos(cos) * (180.0 / math.pi)
    occ = march_plain(Z, ray_steps(rays), maxz, max_steps)
    return (occ != 0) | (inc >= 88.0), inc


def visibility_batch(Z: torch.Tensor, cam: torch.Tensor, XX: torch.Tensor, YY: torch.Tensor, max_steps: int):
    """Z (B, H, W) heights, cam (3,), XX/YY (H, W), all float32 in cell
    units, contiguous, on one device, H and W >= 2 -> (occ (B, H, W) bool,
    incidence degrees (B, H, W) float32); incidence >= 88 degrees counts as
    occluded."""
    if Z.dim() != 3 or cam.shape != (3,) or XX.shape != Z.shape[1:] or YY.shape != Z.shape[1:] or min(Z.shape[1:]) < 2:
        raise ValueError(f"visibility_batch: Z {tuple(Z.shape)}, cam {tuple(cam.shape)}, XX {tuple(XX.shape)}, "
                         f"YY {tuple(YY.shape)}")
    if not (Z.dtype == cam.dtype == XX.dtype == YY.dtype == torch.float32):
        raise ValueError("visibility_batch: Z, cam, XX and YY must be float32")
    if not all(t.is_contiguous() for t in (Z, cam, XX, YY)):
        raise ValueError("visibility_batch: Z, cam, XX and YY must be contiguous")
    if not on_cuda(Z, cam, XX, YY):
        return visibility_batch_plain(Z, cam, XX, YY, max_steps)
    B, H, W = Z.shape
    occ = torch.empty((B, H, W), dtype=torch.uint8, device=Z.device)
    inc = torch.empty((B, H, W), dtype=torch.float32, device=Z.device)
    maxz = torch.empty(B, dtype=torch.float32, device=Z.device)  # each frame's max z
    counter = torch.empty(1, dtype=torch.int32, device=Z.device)  # the tile queue
    _build.launch("wass_visibility_batch", "visibility_batch kernel", Z.device,
                  Z.data_ptr(), cam.data_ptr(), XX.data_ptr(), YY.data_ptr(), occ.data_ptr(), inc.data_ptr(),
                  maxz.data_ptr(), counter.data_ptr(), B, H, W, int(max_steps))
    LAUNCHES.add("visibility_batch")
    return occ.view(torch.bool), inc
