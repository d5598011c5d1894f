"""Sequence-wide extrinsic auto-calibration (wass_autocalibrate).

Counterpart of wass_tpu/calib/autocalibrate.py: pool the epipolar-filtered
matches of every frame, estimate one relative pose by RANSAC, triangulate
the inliers, refine with the Schur-complement LM bundle adjustment,
polish the 5-dof pose on the Sampson distance of every pooled inlier
(annealed Cauchy rounds on the device, then float64 rounds on the host),
and keep the result only where the host float64 median epipolar error
does not get worse; broadcast ext_R / ext_T and H.xml to every workdir.

The pool is padded to a power-of-two capacity with a mask, as in the JAX
package.  The RANSAC samples come in as AutocalDraws or are drawn from a
torch.Generator on the device seeded with cfg.seed; the BA subsample is a
numpy draw with the same seed, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from wass_tpu_torch.calib.ba import lm_refine_pose_epipolar, lm_refine_two_view, polish_pose_f64
from wass_tpu_torch.core.triangulate import triangulate_normalized
from wass_tpu_torch.device import resolve_device
from wass_tpu_torch.match.pipeline import ransac_capacity
from wass_tpu_torch.match.pose import relative_pose_ransac


class AutocalResult(NamedTuple):
    R: np.ndarray  # refined cam0 -> cam1 rotation
    T: np.ndarray  # refined translation, unit norm, (3, 1)
    epi_med_before: float  # median Sampson px over the pooled inliers, RANSAC pose
    epi_med_after: float  # the same under the returned pose (never worse)
    n_inliers: int
    improved: bool


@dataclasses.dataclass(frozen=True)
class AutocalConfig:
    """The JAX package's fields and defaults (see its comments for the
    measurements behind them)."""

    ransac_threshold_px: float = 1.5  # wass_autocalibrate.cpp:177 (1.5 px / focal)
    ransac_hypotheses: int = 8192
    max_points: int = 16384  # BA capacity (pooled inliers are subsampled)
    ba_iters: int = 60
    # Sampson polish over all pooled inliers: Cauchy rounds with the robust
    # scale re-measured each round from the current pose's residual MAD,
    # floored at polish_final_threshold_px.
    polish_rounds: int = 5
    polish_iters: int = 60
    polish_final_threshold_px: float = 0.05
    seed: int = 0


class AutocalDraws(NamedTuple):
    """The RANSAC samples of one autocalibrate_pooled call:
    idx_h (ransac_hypotheses, 4), idx_e (ransac_hypotheses // 4, 8), below
    the pool's padded capacity."""

    idx_h: torch.Tensor
    idx_e: torch.Tensor


def autocalibrate_pooled(uv0: np.ndarray, uv1: np.ndarray, K0: np.ndarray, K1: np.ndarray,
                         cfg: AutocalConfig = AutocalConfig(), device="cuda",
                         draws: Optional[AutocalDraws] = None) -> Optional[AutocalResult]:
    """The global reduction on pooled pixel matches, (M, 2) each."""
    if len(uv0) < 8:
        return None
    dev = resolve_device(device)
    K0 = np.asarray(K0, np.float64)
    K1 = np.asarray(K1, np.float64)
    K0i = np.linalg.inv(K0)
    K1i = np.linalg.inv(K1)
    p0n = (np.c_[uv0, np.ones(len(uv0))] @ K0i.T)[:, :2]
    p1n = (np.c_[uv1, np.ones(len(uv1))] @ K1i.T)[:, :2]

    cap = ransac_capacity(len(p0n))
    pad = cap - len(p0n)
    p0j = torch.as_tensor(np.pad(p0n, ((0, pad), (0, 0))), dtype=torch.float32).to(dev)
    p1j = torch.as_tensor(np.pad(p1n, ((0, pad), (0, 0))), dtype=torch.float32).to(dev)
    vj = torch.as_tensor(np.pad(np.ones(len(p0n), bool), (0, pad))).to(dev)

    nh = cfg.ransac_hypotheses
    if draws is None:
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        idx_h = torch.randint(0, cap, (nh, 4), generator=gen, device=dev)
        idx_e = torch.randint(0, cap, (nh // 4, 8), generator=gen, device=dev)
    else:
        idx_h, idx_e = draws.idx_h.to(dev), draws.idx_e.to(dev)
        if int(max(idx_h.max(), idx_e.max())) >= cap:
            raise ValueError(f"RANSAC draws index past the capacity {cap}")
    er = relative_pose_ransac(p0j, p1j, vj, idx_h, idx_e, threshold=cfg.ransac_threshold_px / K0[0, 0])
    R = er.R.cpu().numpy().astype(np.float64)
    T = er.T.cpu().numpy().astype(np.float64)

    # Triangulate the inliers, keep the points in front (z >= 0, :251-287).
    pts_t = triangulate_normalized(p0j, p1j, torch.as_tensor(R, dtype=torch.float32).to(dev),
                                   torch.as_tensor(T, dtype=torch.float32).to(dev))
    pts = pts_t.cpu().numpy()
    good = er.inliers.cpu().numpy() & (pts[:, 2] > 0)
    good[len(p0n):] = False
    if good.sum() < 24:
        return None

    # Host float64 Sampson distances (linear px) over all pooled matches:
    # every scale estimate, accept-if-better test and reported statistic
    # uses them (the float32 device metric is inflated near the noise floor).
    x0h = np.c_[uv0.astype(np.float64), np.ones(len(uv0))]
    x1h = np.c_[uv1.astype(np.float64), np.ones(len(uv1))]
    good_np = good[: len(p0n)]

    def sampson_px_f64(Rc, Tc):
        Tc = np.asarray(Tc, np.float64).reshape(3)
        sk = np.array([[0, -Tc[2], Tc[1]], [Tc[2], 0, -Tc[0]], [-Tc[1], Tc[0], 0]])
        F = K1i.T @ (sk @ np.asarray(Rc, np.float64)) @ K0i
        Fx0 = x0h @ F.T
        Ftx1 = x1h @ F
        num = np.abs(np.sum(x1h * Fx0, -1))
        return num / np.sqrt(Fx0[:, 0] ** 2 + Fx0[:, 1] ** 2 + Ftx1[:, 0] ** 2 + Ftx1[:, 1] ** 2 + 1e-300)

    def med_px_f64(Rc, Tc) -> float:
        return float(np.median(sampson_px_f64(Rc, Tc)[good_np]))

    before_med = med_px_f64(R, T)

    # Subsample to the BA capacity.
    idx = np.flatnonzero(good)
    rng = np.random.default_rng(cfg.seed)
    if len(idx) > cfg.max_points:
        idx = rng.choice(idx, cfg.max_points, replace=False)
    bcap = ransac_capacity(len(idx))
    sel = np.zeros(bcap, dtype=np.int64)
    sel[: len(idx)] = idx
    bmask = np.zeros(bcap, bool)
    bmask[: len(idx)] = True
    sel_t = torch.as_tensor(sel).to(dev)
    ba = lm_refine_two_view(torch.as_tensor(R, dtype=torch.float32).to(dev),
                            torch.as_tensor(T, dtype=torch.float32).to(dev), pts_t[sel_t], p0j[sel_t], p1j[sel_t],
                            torch.as_tensor(bmask).to(dev), max_iters=cfg.ba_iters)
    R_ba = ba.R.cpu().numpy().astype(np.float64)
    T_ba = ba.T.cpu().numpy().astype(np.float64)
    T_ba = T_ba / np.linalg.norm(T_ba)  # :330-335

    # BA accept-if-better on the float64 median (wass_autocalibrate.cpp:363-382).
    improved = med_px_f64(R_ba, T_ba) < before_med
    Rf, Tf = (R_ba, T_ba) if improved else (R, T)

    # --- Sampson polish over all pooled inliers ----------------------------
    if cfg.polish_rounds > 0:
        # Cauchy rounds with a self-annealing scale: s is re-measured each
        # round from the current pose's residual MAD, floored at the noise
        # floor and kept non-increasing.
        gmask = torch.as_tensor(good).to(dev)
        min_fit = max(24, int(0.1 * int(good.sum())))
        f_px = 0.5 * (K0[0, 0] + K1[0, 0])  # px -> normalized coords
        Rp, Tp = np.asarray(Rf), np.asarray(Tf).reshape(3)
        s = 0.99 * cfg.ransac_threshold_px
        for _ in range(cfg.polish_rounds):
            d_now = sampson_px_f64(Rp, Tp)[good_np]
            mad_now = 1.4826 * float(np.median(d_now)) if d_now.size else 0.0
            s = min(s, max(cfg.polish_final_threshold_px, mad_now))
            pol = lm_refine_pose_epipolar(torch.as_tensor(Rp, dtype=torch.float32).to(dev),
                                          torch.as_tensor(Tp, dtype=torch.float32).to(dev), p0j, p1j, gmask,
                                          max_iters=cfg.polish_iters, robust_scale=float(s) / f_px)
            Rp = pol.R.cpu().numpy().astype(np.float64)
            Tp = pol.T.cpu().numpy().astype(np.float64)
            Tp = Tp / np.linalg.norm(Tp)
        # Accept the annealed pose iff enough genuine support survives near
        # the final scale.
        core = good_np & (sampson_px_f64(Rp, Tp) < s * 3.0)
        if int(core.sum()) >= min_fit:
            Rf, Tf = Rp, Tp
            improved = True
            # Float64 host rounds with re-measured Cauchy weights remove the
            # float32 floor of the device polish.
            R64, T64 = np.asarray(Rf, np.float64), np.asarray(Tf, np.float64).reshape(3)
            for _ in range(3):
                d64 = sampson_px_f64(R64, T64)
                mad = float(np.median(d64[good_np])) if good_np.any() else 0.0
                s_px = max(1.4826 * mad, cfg.polish_final_threshold_px)
                w_np = np.where(good_np, 1.0 / (1.0 + (d64 / (2.0 * s_px)) ** 2), 0.0)
                R_new, T_new, rms0, rms1 = polish_pose_f64(R64, T64, p0n, p1n, w_np)
                if rms1 > rms0:
                    break
                R64, T64 = R_new, T_new
            if np.median(sampson_px_f64(R64, T64)[good_np]) <= np.median(
                    sampson_px_f64(Rf, Tf)[good_np]) * (1.0 + 1e-9):
                Rf, Tf = R64, T64

    # --- final accept-if-better on the float64 median ----------------------
    final_med = med_px_f64(Rf, Tf)
    if final_med > before_med:
        Rf, Tf = R, T
        final_med = before_med
        improved = False
    return AutocalResult(R=Rf, T=np.asarray(Tf).reshape(3, 1), epi_med_before=before_med, epi_med_after=final_med,
                         n_inliers=int(good.sum()), improved=improved)


def autocalibrate_sequence(workdirs: Sequence, cfg: AutocalConfig = AutocalConfig(),
                           device="cuda") -> Optional[AutocalResult]:
    """Pool matches_epionly.txt of every frame workdir (:119-160), run the
    reduction, and on success write ext_R / ext_T and H.xml to every
    workdir (:366-377), as the reference always writes its final
    extrinsics."""
    uv0_all, uv1_all = [], []
    K0 = K1 = None
    for wd in workdirs:
        try:
            if K0 is None:
                K0 = wd.load_intrinsics(0)
                K1 = wd.load_intrinsics(1)
            a, b = wd.load_matches("matches_epionly.txt")
        except FileNotFoundError:
            continue
        uv0_all.append(a)
        uv1_all.append(b)
    if not uv0_all or K0 is None:
        return None
    uv0 = np.concatenate(uv0_all)
    uv1 = np.concatenate(uv1_all)
    res = autocalibrate_pooled(uv0, uv1, K0, K1, cfg, device)
    if res is not None:
        H = _pixel_homography(uv0, uv1)
        for wd in workdirs:
            wd.save_extrinsics(res.R, res.T)
            if H is not None:
                wd.save_homography(H)
    return res


def _pixel_homography(uv0: np.ndarray, uv1: np.ndarray):
    """Normalized DLT homography on pixel matches (host, float64)."""
    if len(uv0) < 4:
        return None

    def norm(pts):
        c = pts.mean(0)
        s = np.sqrt(2.0) / max(np.mean(np.linalg.norm(pts - c, axis=1)), 1e-12)
        T = np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1.0]])
        return (np.c_[pts, np.ones(len(pts))] @ T.T)[:, :2], T

    a, Ta = norm(np.asarray(uv0, np.float64))
    b, Tb = norm(np.asarray(uv1, np.float64))
    x0, y0 = a[:, 0], a[:, 1]
    x1, y1 = b[:, 0], b[:, 1]
    z = np.zeros_like(x0)
    o = np.ones_like(x0)
    r1 = np.stack([x0, y0, o, z, z, z, -x1 * x0, -x1 * y0, -x1], -1)
    r2 = np.stack([z, z, z, x0, y0, o, -y1 * x0, -y1 * y0, -y1], -1)
    _, _, Vt = np.linalg.svd(np.concatenate([r1, r2]), full_matrices=False)
    H = np.linalg.inv(Tb) @ Vt[-1].reshape(3, 3) @ Ta
    return H / H[2, 2]
