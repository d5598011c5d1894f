"""The sparse matching stage (wass_match).

Counterpart of wass_tpu/match/pipeline.py: features on both undistorted
frames -> kNN candidates -> game-theoretic match rounds (the iidyn kernel
on a card) -> LK subpixel refinement -> relative-pose RANSAC on normalized
coordinates -> epipolar error statistics in host float64.

Outputs mirror the workdir contract: ext_R / ext_T (x1 = R x0 + T, |T| = 1),
matches.txt (pose inliers), matches_epionly.txt (epipolar inliers),
matches_unfiltered.txt, matcher_stats.csv.

Random numbers: the JAX package draws inside its functions from
jax.random keys; the port takes its draws as tensors (MatchDraws), so a
test can hand both packages the same samples.  Without them match_frame
draws from a torch.Generator on the device seeded with cfg.seed.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from wass_tpu_torch.core.triangulate import triangulate_normalized
from wass_tpu_torch.device import resolve_device
from wass_tpu_torch.match.features import detect_features
from wass_tpu_torch.match.matcher import generate_candidates, gt_match, nearest_match, payoff_matrix
from wass_tpu_torch.match.pose import relative_pose_ransac
from wass_tpu_torch.match.refine import refine_matches_lk
from wass_tpu_torch.prepare.degradation import auto_smooth_sigma, classify, estimate_degradation
from wass_tpu_torch.stereo.cost import gauss_blur


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Defaults from the reference matcher options (wass_match.cpp:39-45,
    FeatureSet.cpp:42-47, GTMatcher.cpp:33); the JAX package's fields and
    defaults, whose comments give the measurements behind the AUTO rules."""

    num_features: int = 0  # 0 = AUTO: 2000 at <= 1.5 MP, 4000 above
    n_candidates_per_feature: int = 3
    nndr: float = 0.25
    matcher_lambda: float = 1e-5
    population_threshold: float = 0.7
    min_group_size: int = 5
    max_rounds: int = 20
    max_epi_distance: float = 0.5  # px
    skip_gt: bool = False
    hessian_threshold: float = 1e-4
    feature_grid_cell: int = 0  # 0 = AUTO: 12 at <= 1.5 MP, 8 above
    area_subdivision: int = 5
    ransac_hypotheses: int = 1024
    ransac_confidence: float = 0.9999
    iidyn_iters: int = 20000
    lk_refine: bool = True
    lk_win: int = 0  # 0 = AUTO: max(7, round(7 * width / 1024))
    # Gaussian pre-smoothing of the 8-bit inputs; negative = AUTO from the
    # estimated degradation (prepare/degradation.py), which also switches
    # heavy sensor noise to half-resolution matching.
    input_smooth_sigma: float = -1.0
    seed: int = 0


class MatchDraws(NamedTuple):
    """The random numbers of one match_frame call.

    uniforms: (max_rounds, C) in [0, 1), row r for the initial population
    of match round r (C = features x candidates per feature).
    idx_h: (ransac_hypotheses, 4) and idx_e: (ransac_hypotheses // 4, 8)
    sample indices below the padded RANSAC capacity N (the smallest power
    of two >= max(matches, 64))."""

    uniforms: torch.Tensor
    idx_h: torch.Tensor
    idx_e: torch.Tensor


class MatchStageResult(NamedTuple):
    R: np.ndarray
    T: np.ndarray
    uv0_all: np.ndarray  # (M, 2) all GT-matcher matches
    uv1_all: np.ndarray
    uv0_epi: np.ndarray  # epipolar-inlier matches
    uv1_epi: np.ndarray
    uv0_pose: np.ndarray  # pose (chirality) inlier matches
    uv1_pose: np.ndarray
    epi_avg: float
    epi_std: float
    epi_min: float
    epi_max: float
    n_matches: int


def _half(a: np.ndarray) -> np.ndarray:
    """2x2 block mean in float64 (odd trailing rows and columns dropped)."""
    a = np.asarray(a, np.float64)
    a = a[: a.shape[0] // 2 * 2, : a.shape[1] // 2 * 2]
    return 0.25 * (a[0::2, 0::2] + a[1::2, 0::2] + a[0::2, 1::2] + a[1::2, 1::2])


def ransac_capacity(n: int) -> int:
    """The padded correspondence count of the RANSAC stages."""
    return int(2 ** np.ceil(np.log2(max(n, 64))))


def match_frame(img0: np.ndarray, img1: np.ndarray, K0: np.ndarray, K1: np.ndarray,
                cfg: MatchConfig = MatchConfig(), device="cuda",
                draws: Optional[MatchDraws] = None) -> Optional[MatchStageResult]:
    """The matching stage for one undistorted frame pair; None when fewer
    than 8 matches or pose inliers survive."""
    dev = resolve_device(device)
    half_res = False
    if cfg.input_smooth_sigma < 0:
        est = estimate_degradation(np.asarray(img0))
        smooth_sigma = auto_smooth_sigma(est, "match")
        if classify(est) == "noise_heavy":
            # Heavy sensor noise: match a 2x2 block mean at the clean sigma,
            # coordinates mapped back to full resolution at the end.
            half_res = True
            smooth_sigma = 0.8
    else:
        smooth_sigma = float(cfg.input_smooth_sigma)
    if half_res:
        img0, img1 = _half(img0), _half(img1)
        S = np.array([[0.5, 0.0, -0.25], [0.0, 0.5, -0.25], [0.0, 0.0, 1.0]])  # u_half = S u_full
        K0 = S @ np.asarray(K0, np.float64)
        K1 = S @ np.asarray(K1, np.float64)

    i0 = torch.as_tensor(np.asarray(img0, np.float32)).to(dev)
    i1 = torch.as_tensor(np.asarray(img1, np.float32)).to(dev)
    if smooth_sigma > 0:
        i0, i1 = gauss_blur(i0, smooth_sigma), gauss_blur(i1, smooth_sigma)

    # AUTO feature budget and NMS cell, from the size of the image matched.
    area_mp = i0.shape[0] * i0.shape[1] / 1e6
    n_feat = cfg.num_features or (2000 if area_mp <= 1.5 else 4000)
    grid_cell = cfg.feature_grid_cell or (12 if area_mp <= 1.5 else 8)
    f0, f1 = (detect_features(i, max_features=n_feat, hessian_threshold=cfg.hessian_threshold, grid_cell=grid_cell,
                              area_subdivision=cfg.area_subdivision) for i in (i0, i1))

    gen = None
    if draws is None:
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    cand = generate_candidates(f0, f1, cfg.n_candidates_per_feature, cfg.nndr)
    if cfg.skip_gt:
        result = nearest_match(cand)
    else:
        C = cand.src.shape[0]
        uniforms = (torch.rand((cfg.max_rounds, C), generator=gen, device=dev) if draws is None
                    else draws.uniforms.to(dev))
        if uniforms.shape[0] < cfg.max_rounds or uniforms.shape[1] != C:
            raise ValueError(f"uniforms of shape {tuple(uniforms.shape)}, expected ({cfg.max_rounds}, {C})")
        pay = payoff_matrix(f0, f1, cand, cfg.matcher_lambda)
        result = gt_match(f0, f1, cand, pay, uniforms, pop_threshold=cfg.population_threshold,
                          max_rounds=cfg.max_rounds, min_group_size=cfg.min_group_size,
                          iidyn_iters=cfg.iidyn_iters)
        del pay

    sel = result.valid.cpu().numpy()
    src = result.src.cpu().numpy()[sel]
    dst = result.dst.cpu().numpy()[sel]
    uv0 = f0.xy.cpu().numpy()[src]
    uv1 = f1.xy.cpu().numpy()[dst]
    if len(uv0) < 8:
        return None
    if cfg.lk_refine:
        lk_win = cfg.lk_win or max(7, round(7 * i0.shape[1] / 1024))
        uv1 = refine_matches_lk(i0, i1, torch.as_tensor(uv0).to(dev), torch.as_tensor(uv1).to(dev),
                                win=lk_win).cpu().numpy()

    # Normalized coordinates for the essential matrix (wass_match.cpp:311-326).
    K0 = np.asarray(K0, np.float64)
    K1 = np.asarray(K1, np.float64)
    K0i = np.linalg.inv(K0)
    K1i = np.linalg.inv(K1)
    focal = 0.5 * (K0[0, 0] + K0[1, 1])
    p0n = (np.c_[uv0, np.ones(len(uv0))] @ K0i.T)[:, :2]
    p1n = (np.c_[uv1, np.ones(len(uv1))] @ K1i.T)[:, :2]

    # Padded to a power-of-two capacity, as the JAX package pads for static shapes.
    cap = ransac_capacity(len(p0n))
    pad = cap - len(p0n)
    p0j = torch.as_tensor(np.pad(p0n, ((0, pad), (0, 0))), dtype=torch.float32).to(dev)
    p1j = torch.as_tensor(np.pad(p1n, ((0, pad), (0, 0))), dtype=torch.float32).to(dev)
    vj = torch.as_tensor(np.pad(np.ones(len(p0n), bool), (0, pad))).to(dev)
    nh = cfg.ransac_hypotheses
    if draws is None:
        idx_h = torch.randint(0, cap, (nh, 4), generator=gen, device=dev)
        idx_e = torch.randint(0, cap, (nh // 4, 8), generator=gen, device=dev)
    else:
        idx_h, idx_e = draws.idx_h.to(dev), draws.idx_e.to(dev)
        if int(max(idx_h.max(), idx_e.max())) >= cap:
            raise ValueError(f"RANSAC draws index past the capacity {cap}")
    rp = relative_pose_ransac(p0j, p1j, vj, idx_h, idx_e, threshold=cfg.max_epi_distance / focal)

    inl = rp.inliers.cpu().numpy()[: len(p0n)]
    R = rp.R.cpu().numpy().astype(np.float64)
    T = rp.T.cpu().numpy().astype(np.float64)

    # Pose inliers for matches.txt: the epipolar inliers whose triangulation
    # lands in front of both cameras.
    pts = triangulate_normalized(p0j, p1j, torch.as_tensor(R, dtype=torch.float32).to(dev),
                                 torch.as_tensor(T, dtype=torch.float32).to(dev)).cpu().numpy()[: len(p0n)]
    front = (pts[:, 2] > 0) & ((pts @ R.T + T)[:, 2] > 0)
    pose_inl = inl & front
    if pose_inl.sum() < 8:
        return None

    # Epipolar error stats on pixel coords with F = K1^-T E K0^-1, in host
    # float64 (the float32 metric is inflated by cancellation at megapixel
    # coordinates).
    F = K1i.T @ rp.E.cpu().numpy().astype(np.float64) @ K0i
    x0 = np.c_[uv0[pose_inl].astype(np.float64), np.ones(int(pose_inl.sum()))]
    x1 = np.c_[uv1[pose_inl].astype(np.float64), np.ones(int(pose_inl.sum()))]
    Fx0 = x0 @ F.T
    Ftx1 = x1 @ F
    num = np.abs(np.sum(x1 * Fx0, -1))
    d_sym = 0.5 * (num / np.sqrt(Fx0[:, 0] ** 2 + Fx0[:, 1] ** 2 + 1e-300)
                   + num / np.sqrt(Ftx1[:, 0] ** 2 + Ftx1[:, 1] ** 2 + 1e-300))

    epi_scale = 1.0
    if half_res:
        # Back to full resolution (the inverse of S); distances scale with the grid.
        uv0 = uv0 * 2.0 + 0.5
        uv1 = uv1 * 2.0 + 0.5
        epi_scale = 2.0
    return MatchStageResult(
        R=R, T=T.reshape(3, 1),
        uv0_all=uv0, uv1_all=uv1,
        uv0_epi=uv0[inl], uv1_epi=uv1[inl],
        uv0_pose=uv0[pose_inl], uv1_pose=uv1[pose_inl],
        epi_avg=float(d_sym.mean()) * epi_scale,
        epi_std=float(d_sym.std()) * epi_scale,
        epi_min=float(d_sym.min()) * epi_scale,
        epi_max=float(d_sym.max()) * epi_scale,
        n_matches=int(pose_inl.sum()),
    )
