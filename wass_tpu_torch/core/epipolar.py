"""Epipolar and reprojection error statistics on tensors.

Counterpart of wass_tpu/core/epipolar.py (WASS::epi::evaluate_epipolar_error
and evaluate_structure_error): batched, mask-aware, float32.  The matcher
scores RANSAC hypotheses with `sampson_distance`; the statistics are the
quality gates of the match and autocalibrate stages.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class ErrorStats(NamedTuple):
    avg: torch.Tensor
    std: torch.Tensor
    min: torch.Tensor
    max: torch.Tensor


def _masked_stats(errors: torch.Tensor, mask: Optional[torch.Tensor]) -> ErrorStats:
    if mask is None:
        avg = errors.mean()
        std = torch.sqrt(((errors - avg) ** 2).mean())
        return ErrorStats(avg, std, errors.min(), errors.max())
    m = mask.to(errors.dtype)
    n = torch.clamp_min(m.sum(), 1.0)
    avg = (errors * m).sum() / n
    std = torch.sqrt((m * (errors - avg) ** 2).sum() / n)
    big = torch.finfo(errors.dtype).max
    return ErrorStats(avg, std, torch.where(mask, errors, big).min(), torch.where(mask, errors, -big).max())


def _homogeneous(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def symmetric_epipolar_distance(F: torch.Tensor, p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """Per-correspondence symmetric epipolar distance (epipolar.cpp:16-29):
    0.5 * (|r^T F l| / ||(F l)_xy|| + |l^T F^T r| / ||(F^T r)_xy||)."""
    l, r = _homogeneous(p0), _homogeneous(p1)
    Fl = l @ F.transpose(-1, -2)  # F @ l
    Fr = r @ F  # F^T @ r
    num = (Fl * r).sum(-1).abs()
    d0 = num / torch.sqrt(Fl[..., 0] ** 2 + Fl[..., 1] ** 2 + 1e-30)
    d1 = num / torch.sqrt(Fr[..., 0] ** 2 + Fr[..., 1] ** 2 + 1e-30)
    return 0.5 * (d0 + d1)


def sampson_distance(F: torch.Tensor, p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """First-order geometric (Sampson) distance, squared: the RANSAC score."""
    l, r = _homogeneous(p0), _homogeneous(p1)
    Fl = l @ F.transpose(-1, -2)
    Fr = r @ F
    num = (Fl * r).sum(-1) ** 2
    den = Fl[..., 0] ** 2 + Fl[..., 1] ** 2 + Fr[..., 0] ** 2 + Fr[..., 1] ** 2
    return num / torch.clamp_min(den, 1e-30)


def epipolar_error_stats(F: torch.Tensor, p0: torch.Tensor, p1: torch.Tensor,
                         mask: Optional[torch.Tensor] = None) -> ErrorStats:
    return _masked_stats(symmetric_epipolar_distance(F, p0, p1), mask)


def structure_error_stats(pts3d: torch.Tensor, p0: torch.Tensor, p1: torch.Tensor, R: torch.Tensor,
                          T: torch.Tensor, K0: torch.Tensor, K1: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> ErrorStats:
    """Mean reprojection error of triangulated structure (epipolar.cpp:42-80)."""
    rep0 = pts3d @ K0.T
    rep0 = rep0[..., :2] / rep0[..., 2:3]
    x1 = pts3d @ R.T + T.reshape(3)
    rep1 = x1 @ K1.T
    rep1 = rep1[..., :2] / rep1[..., 2:3]
    err = 0.5 * (torch.linalg.norm(rep0 - p0, dim=-1) + torch.linalg.norm(rep1 - p1, dim=-1))
    return _masked_stats(err, mask)
