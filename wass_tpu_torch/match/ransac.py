"""Essential-matrix RANSAC and pose recovery, batched.

Counterpart of wass_tpu/match/ransac.py (cv::findEssentialMat,
cv::recoverPose and decomposeEssentialMat as the WASS matcher and
autocalibrate use them): every minimal sample is drawn up front, every
hypothesis is solved by a batched 8-point eigen-solve, and the best model
by Sampson-inlier count is refit on its inliers.  Coordinates are
normalized (K^-1 applied).

The samples come in as `idx`, (n_hypotheses, 8) indices into the padded
correspondences (randint(0, N) per hypothesis in the JAX package), so a
test can hand both packages the same samples.

Singular and eigen vectors are defined up to sign (LAPACK and cuSOLVER may
choose differently); E is used only through sign-free quantities (the
Sampson distance, U S V^T), and decompose_essential forces det +1.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from wass_tpu_torch.core.epipolar import sampson_distance
from wass_tpu_torch.core.triangulate import triangulate_normalized


class EssentialResult(NamedTuple):
    E: torch.Tensor  # (3, 3)
    inliers: torch.Tensor  # (N,) bool
    n_inliers: torch.Tensor


def null_vector(A: torch.Tensor) -> torch.Tensor:
    """(..., 9): the eigenvector of A^T A with the smallest eigenvalue.

    The float32 A^T A is decomposed in float64 and the vector rounded: the
    9x9 systems of the minimal samples are rank-deficient, and float32
    eigen-solvers of different libraries (MKL's on the CPU, cuSOLVER's,
    jaxlib's) disagree there by up to 3e-3 in the solution, which decides
    which of near-tied RANSAC candidates wins."""
    M = A.transpose(-1, -2) @ A
    return torch.linalg.eigh(M.to(torch.float64))[1][..., :, 0].to(A.dtype)


def _project_essential(E: torch.Tensor) -> torch.Tensor:
    """The closest matrix with two equal singular values and a zero third."""
    U, S, Vt = torch.linalg.svd(E)
    s = (S[..., 0] + S[..., 1]) / 2.0
    diag = torch.stack([s, s, torch.zeros_like(s)], dim=-1)
    return (U * diag[..., None, :]) @ Vt  # U @ diag(s, s, 0) @ Vt


def eight_point(p0: torch.Tensor, p1: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted 8-point E from (..., N, 2) correspondences, projected onto
    the essential manifold."""
    x0, y0 = p0[..., 0], p0[..., 1]
    x1, y1 = p1[..., 0], p1[..., 1]
    ones = torch.ones_like(x0)
    A = torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0, ones], dim=-1) * w[..., None]
    E = null_vector(A).reshape(*A.shape[:-2], 3, 3)
    return _project_essential(E)


def essential_ransac(p0: torch.Tensor, p1: torch.Tensor, valid: torch.Tensor, idx: torch.Tensor, threshold: float,
                     refit_rounds: int = 2) -> EssentialResult:
    """RANSAC essential matrix on normalized correspondences.

    idx: (n_hypotheses, 8) sample indices; a hypothesis with an invalid
    sample scores -1.  threshold: the Sampson distance bound in normalized
    units (pixel threshold / focal, wass_match.cpp:280)."""
    t2 = threshold * threshold
    ok = valid[idx].all(-1)
    Es = eight_point(p0[idx], p1[idx], torch.ones(idx.shape, dtype=p0.dtype, device=p0.device))
    d = sampson_distance(Es, p0, p1)  # (n_hypotheses, N)
    scores = torch.where(ok, ((d < t2) & valid).sum(-1), -1)
    E = Es[torch.argmax(scores)]
    for _ in range(refit_rounds):  # iterative refit: weighted all-point 8-point
        w = ((sampson_distance(E, p0, p1) < t2) & valid).to(p0.dtype)
        E = eight_point(p0, p1, w)
    inliers = (sampson_distance(E, p0, p1) < t2) & valid
    return EssentialResult(E=E, inliers=inliers, n_inliers=inliers.sum())


class PoseResult(NamedTuple):
    R: torch.Tensor  # (3, 3) with x1 = R x0 + T
    T: torch.Tensor  # (3,), unit norm
    n_valid: torch.Tensor  # chirality votes of the winner


def decompose_essential(E: torch.Tensor):
    """E -> (R1, R2, t) (cv::decomposeEssentialMat), batched."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))[..., None, None]
    Vt = Vt * torch.sign(torch.linalg.det(Vt))[..., None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    return R1, R2, U[..., :, 2]


def recover_pose(E: torch.Tensor, p0: torch.Tensor, p1: torch.Tensor, mask: torch.Tensor) -> PoseResult:
    """Chirality vote over the 4 (R, T) alternatives (wass_autocalibrate.cpp
    :183-220, count_valid_points :41-57): triangulate the masked
    correspondences, count z > 1 in camera 0, ties to the larger R[0, 0]."""
    R1, R2, t = decompose_essential(E)
    alts_R = torch.stack([R1, R1, R2, R2])
    alts_T = torch.stack([t, -t, t, -t])
    votes = torch.stack([((triangulate_normalized(p0, p1, R, T)[:, 2] > 1.0) & mask).sum()
                         for R, T in zip(alts_R, alts_T)])
    best = torch.argmax(votes.to(torch.float32) + 1e-6 * alts_R[:, 0, 0])
    return PoseResult(R=alts_R[best], T=alts_T[best], n_valid=votes[best])
