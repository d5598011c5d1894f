"""Wrapper of the visibility ray-march CUDA kernel and its plain version.

Counterpart of the compiled `lax.while_loop` of
wass_tpu/post/geometry.py (`_visibility_device_batch`, :94, and
`_occlusion_device`, :33), csrc/visibility.cu.  Every cell of every frame
of a slab casts a ray from (x, y, Z) along its direction d (cell units,
the larger horizontal component one cell a step) and is occluded when the
ray meets the surface again (Z >= the ray's height) before it leaves the
grid or climbs above the frame's highest cell.  `march` launches the
kernel for CUDA tensors and runs `march_plain` for CPU tensors only.
"""

from __future__ import annotations

import torch

from wass_tpu_torch import _build
from wass_tpu_torch.device import on_cuda
from wass_tpu_torch.launches import LaunchCounts

LAUNCHES = LaunchCounts({"visibility_march": 0})


def march_plain(Z: torch.Tensor, d: torch.Tensor, maxz: torch.Tensor, max_steps: int) -> torch.Tensor:
    """The JAX loop's steps over all rays at once, stopping when no ray is
    active (a host read a step).  The bounds are tested on the rounded
    floats, as the kernel does (see csrc/visibility.cu)."""
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
    for _ in range(max_steps):
        if not bool(active.any()):
            break
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
    return occ.reshape(B, H, W).to(torch.uint8)


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
    err = _build.load().wass_visibility_march(
        Z.data_ptr(), d.data_ptr(), maxz.data_ptr(), occ.data_ptr(), B, H, W, int(max_steps),
        _build.stream_handle(Z.device),
    )
    _build.check(err, "visibility_march kernel")
    LAUNCHES.add("visibility_march")
    return occ
