"""Subpixel match refinement by inverse-compositional Lucas-Kanade.

Counterpart of wass_tpu/match/refine.py: for each correspondence a
translational LK alignment of a (2 win + 1)^2 window of image 0 onto
image 1, from 2x2 normal equations of gradient sums, batched over the
matches.
"""

from __future__ import annotations

import torch

from wass_tpu_torch.ops.sampling import bilinear_sample


def refine_matches_lk(img0: torch.Tensor, img1: torch.Tensor, uv0: torch.Tensor, uv1: torch.Tensor,
                      win: int = 7, iters: int = 10) -> torch.Tensor:
    """(M, 2) uv1 refined so that img1 around uv1 best aligns with img0
    around uv0; a match that moves win or more keeps its initial uv1."""
    offs = torch.arange(-win, win + 1, dtype=torch.float32, device=img0.device)
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    tx = uv0[:, 0, None, None] + ox
    ty = uv0[:, 1, None, None] + oy
    template = bilinear_sample(img0, tx, ty)
    # Template gradients (inverse compositional: computed once).
    gx = 0.5 * (bilinear_sample(img0, tx + 1, ty) - bilinear_sample(img0, tx - 1, ty))
    gy = 0.5 * (bilinear_sample(img0, tx, ty + 1) - bilinear_sample(img0, tx, ty - 1))
    a = (gx * gx).sum((1, 2))
    b = (gx * gy).sum((1, 2))
    c = (gy * gy).sum((1, 2))
    det = a * c - b * b
    inv = torch.where(det.abs() > 1e-8, 1.0 / torch.clamp_min(det.abs(), 1e-8), 0.0) * torch.sign(det)

    p = uv1
    for _ in range(iters):
        cur = bilinear_sample(img1, p[:, 0, None, None] + ox, p[:, 1, None, None] + oy)
        e = cur - template
        jx = (gx * e).sum((1, 2))
        jy = (gy * e).sum((1, 2))
        d = torch.stack([(c * jx - b * jy) * inv, (a * jy - b * jx) * inv], dim=-1)
        p = p - d.clamp(-1.0, 1.0)
    # Reject divergence: fall back to the initial estimate.
    moved = torch.linalg.norm(p - uv1, dim=-1)
    return torch.where((moved < win)[:, None], p, uv1)
