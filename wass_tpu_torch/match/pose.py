"""Planar-degeneracy-robust relative pose estimation.

Counterpart of wass_tpu/match/pose.py.  A sea surface is quasi-planar,
which makes the 8-point algorithm degenerate, so the hypotheses are:

* 4-point homographies (the minimal model of a plane), each decomposed
  analytically into its two (R, t, n) solutions (Faugeras-Lustman), so
  4 pose candidates each;
* plain 8-point essential matrices (4 chirality alternatives each) for
  parallax-rich scenes.

Every candidate is scored by its chirality-aware Sampson-inlier count and
the winner is polished by Gauss-Newton steps on the robust Sampson cost
(5 dof: so(3) x the tangent of the unit sphere), the Jacobian from
torch.func.jacfwd.  The samples come in as index tensors (idx_h, idx_e),
so a test can hand both packages the same samples.  Scoring runs over
chunks of the candidates: (candidates x matches) intermediates of the
pooled autocalibration (32768 x 4096) would take tens of GB at once;
chunking changes no score, and the argmax keeps its first-index rule.
The (R, t) and (R, -t) candidates of each family are scored by one
evaluation (their Sampson distances are equal and their depths opposite).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from wass_tpu_torch.core.epipolar import sampson_distance
from wass_tpu_torch.core.geometry import rodrigues, skew
from wass_tpu_torch.core.triangulate import triangulate_normalized
from wass_tpu_torch.match.ransac import decompose_essential, eight_point, null_vector

# Pose candidates x correspondences scored at once: a chunk's float32
# intermediates are 16 MB each (~30 live at once), on any device.
SCORE_CHUNK_ELEMENTS = 1 << 22


class RelPoseResult(NamedTuple):
    R: torch.Tensor
    T: torch.Tensor  # unit norm
    E: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def _homography_dlt(p0: torch.Tensor, p1: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted DLT homography from (..., n, 2) normalized correspondences."""
    x0, y0 = p0[..., 0], p0[..., 1]
    x1, y1 = p1[..., 0], p1[..., 1]
    z = torch.zeros_like(x0)
    o = torch.ones_like(x0)
    r1 = torch.stack([x0, y0, o, z, z, z, -x1 * x0, -x1 * y0, -x1], -1)
    r2 = torch.stack([z, z, z, x0, y0, o, -y1 * x0, -y1 * y0, -y1], -1)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None]], dim=-2)
    return null_vector(A).reshape(*A.shape[:-2], 3, 3)


def _decompose_homography(H: torch.Tensor):
    """Calibrated (..., 3, 3) H -> 4 candidate (R, t) pairs each, t
    unnormalized: (..., 4, 3, 3), (..., 4, 3).  H is scaled so that its
    middle singular value is 1."""
    _, S, Vt = torch.linalg.svd(H)
    Hn = H / S[..., 1, None, None]
    s1 = S[..., 0] / S[..., 1]
    s3 = S[..., 2] / S[..., 1]
    V = Vt.transpose(-1, -2)
    v1, v2, v3 = V[..., :, 0], V[..., :, 1], V[..., :, 2]
    denom = torch.sqrt(torch.clamp_min(s1 * s1 - s3 * s3, 1e-12))[..., None]
    a = torch.sqrt(torch.clamp_min(1.0 - s3 * s3, 0.0))[..., None]
    b = torch.sqrt(torch.clamp_min(s1 * s1 - 1.0, 0.0))[..., None]
    u1 = (a * v1 + b * v3) / denom
    u2 = (a * v1 - b * v3) / denom

    def mv(M, v):
        return (M @ v[..., None])[..., 0]

    def solution(u):
        U1 = torch.stack([v2, u, torch.linalg.cross(v2, u)], dim=-1)
        Hv2, Hu = mv(Hn, v2), mv(Hn, u)
        W1 = torch.stack([Hv2, Hu, torch.linalg.cross(Hv2, Hu)], dim=-1)
        R = W1 @ U1.transpose(-1, -2)
        return R, mv(Hn - R, torch.linalg.cross(v2, u))

    Ra, ta = solution(u1)
    Rb, tb = solution(u2)
    return torch.stack([Ra, Ra, Rb, Rb], dim=-3), torch.stack([ta, -ta, tb, -tb], dim=-2)


def _tangent_basis(t: torch.Tensor):
    """Two orthonormal vectors spanning the tangent space of the unit
    sphere at t (branch-free)."""
    e0 = torch.tensor([1.0, 0.0, 0.0], dtype=t.dtype, device=t.device)
    e1 = torch.tensor([0.0, 1.0, 0.0], dtype=t.dtype, device=t.device)
    ref = torch.where(t[0].abs() < 0.9, e0, e1)
    b1 = torch.linalg.cross(t, ref)
    b1 = b1 / torch.clamp_min(torch.linalg.norm(b1), 1e-12)
    return b1, torch.linalg.cross(t, b1)


def relative_pose_ransac(p0: torch.Tensor, p1: torch.Tensor, valid: torch.Tensor, idx_h: torch.Tensor,
                         idx_e: torch.Tensor, threshold: float, gn_iters: int = 10) -> RelPoseResult:
    """RANSAC + GN relative pose from (N, 2) normalized correspondences.

    idx_h: (n_hypotheses, 4) and idx_e: (n_hypotheses // 4, 8) sample
    indices into the N padded slots (a sample with an invalid slot scores
    -1).  threshold: the Sampson distance bound in normalized units
    (px / focal)."""
    t2 = threshold * threshold
    dtype, dev = p0.dtype, p0.device

    def pose_score(R, t):
        """Sampson inliers that triangulate in front of both cameras: the
        chirality term resolves the planar two-fold (Faugeras mirror)
        ambiguity that a pure epipolar score cannot see."""
        return pose_scores(R, t)[0]

    def pose_scores(R, t):
        """The scores of (R, t) and (R, -t) from one evaluation: negating t
        negates E, the triangulated points and z1 exactly and leaves the
        Sampson distance as it is, so the second chirality alternative
        counts the inliers behind both cameras."""
        E = skew(t / torch.clamp_min(torch.linalg.norm(t), 1e-12)) @ R
        inl = (sampson_distance(E, p0, p1) < t2) & valid
        pts = triangulate_normalized(p0, p1, R, t)
        z0 = pts[:, 2]
        z1 = pts @ R[2] + t[2]
        return torch.stack([(inl & (z0 > 0) & (z1 > 0)).sum(), (inl & (z0 < 0) & (z1 < 0)).sum()])

    batched_scores = vmap(pose_scores)
    chunk = max(1, SCORE_CHUNK_ELEMENTS // max(p0.shape[0], 1))

    def scores(Rs, ts, ok):
        """(B, 4, 3, 3), (B, 4, 3), (B,) -> (B * 4,) scores, -1 where a
        sample slot is invalid.  Candidates 1 and 3 are candidates 0 and 2
        with t negated."""
        Rf, tf = Rs[:, 0::2].reshape(-1, 3, 3), ts[:, 0::2].reshape(-1, 3)
        sc = torch.cat([batched_scores(Rf[i:i + chunk], tf[i:i + chunk]) for i in range(0, Rf.shape[0], chunk)])
        return torch.where(ok.repeat_interleave(4), sc.reshape(-1), -1)

    # --- homography hypotheses (4 pose candidates each) --------------------
    P0, P1 = p0[idx_h], p1[idx_h]  # (nh, 4, 2)
    Hs = _homography_dlt(P0, P1, torch.ones(idx_h.shape, dtype=dtype, device=dev))
    # Sign fix: p1 ~ H p0 with a positive scale for the sample points.
    ph = torch.cat([P0, torch.ones_like(P0[..., :1])], -1) @ Hs.transpose(-1, -2)
    sgn = torch.sign(ph[..., 2].sum(-1))
    Hs = Hs * torch.where(sgn == 0, 1.0, sgn)[..., None, None]
    RH, tH = _decompose_homography(Hs)
    flatH = scores(RH, tH, valid[idx_h].all(-1))

    # --- 8-point hypotheses (4 chirality alternatives each) ----------------
    Es = eight_point(p0[idx_e], p1[idx_e], torch.ones(idx_e.shape, dtype=dtype, device=dev))
    R1, R2, te = decompose_essential(Es)
    RE = torch.stack([R1, R1, R2, R2], dim=1)
    tE = torch.stack([te, -te, te, -te], dim=1)
    flatE = scores(RE, tE, valid[idx_e].all(-1))

    # --- the best candidate over both families -----------------------------
    bestH, bestE = torch.argmax(flatH), torch.argmax(flatE)
    use_h = flatH[bestH] >= flatE[bestE]
    R0 = torch.where(use_h, RH.reshape(-1, 3, 3)[bestH], RE.reshape(-1, 3, 3)[bestE])
    t0 = torch.where(use_h, tH.reshape(-1, 3)[bestH], tE.reshape(-1, 3)[bestE])
    t0 = t0 / torch.clamp_min(torch.linalg.norm(t0), 1e-12)

    # --- Gauss-Newton polish on the robust Sampson cost --------------------
    def residuals(params, R_base, t_base):
        R = rodrigues(params[:3]) @ R_base
        b1, b2 = _tangent_basis(t_base)
        t = t_base + params[3] * b1 + params[4] * b2
        t = t / torch.clamp_min(torch.linalg.norm(t), 1e-12)
        d = torch.sqrt(torch.clamp_min(sampson_distance(skew(t) @ R, p0, p1), 1e-24))
        wgt = torch.where(d < threshold, 1.0, threshold / d) * valid  # Huber weights at the threshold
        return d * wgt

    eye5 = torch.eye(5, dtype=dtype, device=dev)
    R_f, t_f = R0, t0
    for _ in range(gn_iters):
        p = torch.zeros(5, dtype=dtype, device=dev)
        J = jacfwd(residuals)(p, R_f, t_f)  # (N, 5)
        r = residuals(p, R_f, t_f)
        dp = -torch.linalg.solve(J.T @ J + 1e-8 * eye5, J.T @ r)
        R_new = rodrigues(dp[:3]) @ R_f
        b1, b2 = _tangent_basis(t_f)
        t_new = t_f + dp[3] * b1 + dp[4] * b2
        t_new = t_new / torch.clamp_min(torch.linalg.norm(t_new), 1e-12)
        # Keep the step only if the chirality-aware inlier count holds.
        better = pose_score(R_new, t_new) >= pose_score(R_f, t_f)
        R_f = torch.where(better, R_new, R_f)
        t_f = torch.where(better, t_new, t_f)

    E_f = skew(t_f) @ R_f
    inl = (sampson_distance(E_f, p0, p1) < t2) & valid
    return RelPoseResult(R=R_f, T=t_f, E=E_f, inliers=inl, n_inliers=inl.sum())
