"""Two-view bundle adjustment and the Sampson pose polish.

Counterpart of wass_tpu/calib/ba.py (the WASS sba_driver around libsba):

* lm_refine_two_view: Levenberg-Marquardt over camera 1's rotation
  increment and translation and the 3D points, camera 0 fixed at the
  identity; per-point Jacobians from torch.func.jacfwd under vmap; the
  normal equations solved by the motion/structure Schur complement
  (batched 3x3 point blocks, a dense 6x6 camera system);
* lm_refine_pose_epipolar: a 5-dof LM polish of the Sampson distance over
  every pooled correspondence (no 3D points);
* polish_pose_f64: the same polish on the host in float64 (numpy), which
  removes the float32 floor near 1e-4 rad.

The LM loops read their stop flag on the host once per step (at most
max_iters reads, once per sequence).  lm_refine_two_view also runs
point-sharded, the JAX package's axis_name hook (a psum of the
camera-block sums): given per-shard point tensors, each on its own
device, it keeps every per-point quantity on its shard's device and adds
the camera-block sums across the shards (parallel/distba.py drives it
over a frame mesh and across ranks).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.func import jacfwd, vmap

from wass_tpu_torch.core.geometry import rodrigues, skew


class BAResult(NamedTuple):
    R: torch.Tensor  # (3, 3) refined cam0 -> cam1 rotation
    T: torch.Tensor  # (3,) refined translation (not renormalized)
    X: torch.Tensor  # (N, 3) refined points (a list of the shards' when point-sharded)
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    n_iters: int


def _point_residual(cam: torch.Tensor, R0: torch.Tensor, X: torch.Tensor, p0: torch.Tensor, p1: torch.Tensor):
    """(4,) residual of one point seen by both cameras (normalized image
    coordinates); cam = (w, T) with R = rodrigues(w) @ R0."""
    R = rodrigues(cam[:3]) @ R0
    r0 = X[:2] / X[2] - p0
    X1 = R @ X + cam[3:]
    r1 = X1[:2] / X1[2] - p1
    return torch.cat([r0, r1])


_res_fn = vmap(_point_residual, in_dims=(None, None, 0, 0, 0))
_jac_fn = vmap(jacfwd(_point_residual, argnums=(0, 2)), in_dims=(None, None, 0, 0, 0))


def _sum_shards(terms, dev, reduce):
    """The shards' terms added in shard order on `dev`, then `reduce`d."""
    acc = terms[0].to(dev)
    for t in terms[1:]:
        acc = acc + t.to(dev)
    return acc if reduce is None else reduce(acc)


def lm_refine_two_view(R_init: torch.Tensor, T_init: torch.Tensor, X_init, p0, p1, mask, max_iters: int = 50,
                       lam0: float = 1e-3, reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> BAResult:
    """LM refinement of (R, T, X) minimizing the masked reprojection error.

    X_init: (N, 3) points in the cam0 frame; p0, p1: (N, 2) normalized
    observations; mask: (N,) bool, False on padded slots.

    Point-sharded (the JAX function's axis_name): X_init, p0, p1 and mask
    are equally long sequences of per-shard tensors, shard k's four on one
    device.  Each shard's residuals, Jacobians, 3x3 point blocks and Schur
    terms are computed on its device; the camera-block sums (the Schur
    complement, its right-hand side, the cost) add across the shards in
    shard order on the first shard's device, the device of R_init and
    T_init, and then go through `reduce` (a sum across ranks), so every
    rank takes the same steps.  The result's X is then the list of the
    shards' points."""
    sharded = isinstance(X_init, (list, tuple))
    Xs = list(X_init) if sharded else [X_init]
    p0s, p1s = (list(p0), list(p1)) if sharded else ([p0], [p1])
    ms = [mk.to(x.dtype) for mk, x in zip(mask if sharded else [mask], Xs)]
    dev, dtype = R_init.device, Xs[0].dtype
    R0s = [R_init.to(x.device) for x in Xs]
    eyes = [torch.eye(3, dtype=dtype, device=x.device) for x in Xs]

    def shard_cost(cam, X, R0, a, b, m):
        r = _res_fn(cam.to(X.device), R0, X, a, b)
        return (r * r * m[:, None]).sum()

    def cost(cam, Xs):
        return _sum_shards([shard_cost(cam, *t) for t in zip(Xs, R0s, p0s, p1s, ms)], dev, reduce)

    def shard_system(cam, lam, X, R0, a, b, m, eye3):
        """Shard terms of the damped normal equations: (S_k, rhs_k) and the
        point blocks' (Ci, B, g_p) for the back-substitution."""
        cam, lam = cam.to(X.device), lam.to(X.device)
        r = _res_fn(cam, R0, X, a, b)  # (N, 4)
        Jc, Jp = _jac_fn(cam, R0, X, a, b)  # (N, 4, 6), (N, 4, 3)
        w = m[:, None, None]
        JcT = Jc.transpose(1, 2) * w.transpose(1, 2)
        Jp_w = Jp * w
        A = torch.einsum("nik,nkj->ij", JcT, Jc)  # (6, 6)
        B = torch.einsum("nik,nkj->nij", JcT, Jp)  # (N, 6, 3)
        Cb = torch.einsum("nki,nkj->nij", Jp_w, Jp)  # (N, 3, 3)
        g_c = -torch.einsum("nik,nk->i", JcT, r)
        g_p = -torch.einsum("nki,nk->ni", Jp_w, r)
        # Damping.
        A_d = A + lam * torch.diag(torch.diagonal(A) + 1e-12)
        C_d = Cb + lam * (Cb * eye3 + 1e-12 * eye3)
        # Point blocks inverted in a batch; padded slots get the identity.
        Ci = torch.linalg.inv(C_d + (1.0 - m)[:, None, None] * eye3) * m[:, None, None]
        # Schur complement onto the camera block.
        BCi = torch.einsum("nij,njk->nik", B, Ci)
        S = A_d - torch.einsum("nik,njk->ij", BCi, B)
        rhs = g_c - torch.einsum("nik,nk->i", BCi, g_p)
        return S, rhs, (Ci, B, g_p)

    cam = torch.cat([torch.zeros(3, dtype=dtype, device=dev), T_init.reshape(3).to(dev)])
    c0 = cost(cam, Xs)
    c_prev = c0
    lam = torch.tensor(lam0, dtype=dtype, device=dev)
    it = 0
    while it < max_iters:
        systems = [shard_system(cam, lam, *t) for t in zip(Xs, R0s, p0s, p1s, ms, eyes)]
        S = _sum_shards([sy[0] for sy in systems], dev, reduce)
        rhs = _sum_shards([sy[1] for sy in systems], dev, reduce)
        dc = torch.linalg.solve(S, rhs)
        X_new = []
        for X, (_, _, (Ci, B, g_p)) in zip(Xs, systems):
            dck = dc.to(X.device)
            X_new.append(X + torch.einsum("nij,nj->ni", Ci, g_p - torch.einsum("nji,j->ni", B, dck)))

        cam_new = cam + dc
        c_new = cost(cam_new, X_new)
        accept = c_new < c_prev
        cam = torch.where(accept, cam_new, cam)
        Xs = [torch.where(accept.to(X.device), Xn, X) for X, Xn in zip(Xs, X_new)]
        lam = torch.where(accept, torch.clamp_min(lam * 0.3, 1e-9), torch.clamp_max(lam * 5.0, 1e6))
        c_next = torch.where(accept, c_new, c_prev)
        rel = (c_prev - c_next).abs() / torch.clamp_min(c_prev, 1e-20)
        done = (~accept & (lam >= 1e6)) | (accept & (rel < 1e-10))
        c_prev = c_next
        it += 1
        if bool(done):
            break
    R = rodrigues(cam[:3]) @ R_init
    return BAResult(R=R, T=cam[3:], X=Xs if sharded else Xs[0], initial_cost=c0, final_cost=c_prev, n_iters=it)


def _tangent_basis(T: torch.Tensor) -> torch.Tensor:
    """(3, 2) orthonormal basis of the plane perpendicular to unit T."""
    e0 = torch.tensor([1.0, 0.0, 0.0], dtype=T.dtype, device=T.device)
    e1 = torch.tensor([0.0, 1.0, 0.0], dtype=T.dtype, device=T.device)
    b1 = torch.linalg.cross(T, torch.where(T[0].abs() < 0.9, e0, e1))
    b1 = b1 / torch.linalg.norm(b1)
    return torch.stack([b1, torch.linalg.cross(T, b1)], dim=-1)


class EpipolarPolishResult(NamedTuple):
    R: torch.Tensor
    T: torch.Tensor  # unit norm
    initial_rms: torch.Tensor  # masked Sampson RMS (normalized coords)
    final_rms: torch.Tensor
    n_iters: int


def lm_refine_pose_epipolar(R_init: torch.Tensor, T_init: torch.Tensor, p0: torch.Tensor, p1: torch.Tensor,
                            mask: torch.Tensor, weights: Optional[torch.Tensor] = None, max_iters: int = 60,
                            robust_scale: Optional[float] = None) -> EpipolarPolishResult:
    """5-dof pose polish minimizing the (weighted) Sampson distance over
    all masked correspondences (normalized coords): R = rodrigues(w) @ R0,
    T = normalize(T0 + B t) on the unit sphere.  robust_scale: the scale c
    of the redescending transform r / sqrt(1 + (r / c)^2), which bounds a
    gross outlier's influence inside the optimization."""
    T0 = T_init.reshape(3) / torch.linalg.norm(T_init)
    B = _tangent_basis(T0)
    x0 = torch.cat([p0, torch.ones_like(p0[:, :1])], dim=-1)
    x1 = torch.cat([p1, torch.ones_like(p1[:, :1])], dim=-1)
    m = mask.to(p0.dtype)
    if weights is not None:
        m = m * torch.sqrt(torch.clamp_min(weights.to(p0.dtype), 0.0))
    n_eff = torch.clamp_min((m * m).sum(), 1.0)

    def residual(theta):
        R = rodrigues(theta[:3]) @ R_init
        T = T0 + B @ theta[3:]
        T = T / torch.linalg.norm(T)
        E = skew(T) @ R
        Ex0 = x0 @ E.T
        Etx1 = x1 @ E
        num = (x1 * Ex0).sum(-1)
        den = Ex0[:, 0] ** 2 + Ex0[:, 1] ** 2 + Etx1[:, 0] ** 2 + Etx1[:, 1] ** 2
        r = num / torch.sqrt(den + 1e-18)
        if robust_scale is not None:
            r = r / torch.sqrt(1.0 + torch.square(r / robust_scale))
        return m * r

    def cost(theta):
        r = residual(theta)
        return (r * r).sum()

    jac = jacfwd(residual)
    theta = torch.zeros(5, dtype=p0.dtype, device=p0.device)
    c0 = cost(theta)
    c_prev = c0
    lam = torch.tensor(1e-3, dtype=p0.dtype, device=p0.device)
    it = 0
    while it < max_iters:
        J = jac(theta)  # (N, 5)
        r = residual(theta)
        H = J.T @ J
        dtheta = torch.linalg.solve(H + lam * torch.diag(torch.diagonal(H) + 1e-12), J.T @ r)
        theta_new = theta - dtheta
        c_new = cost(theta_new)
        accept = c_new < c_prev
        theta = torch.where(accept, theta_new, theta)
        lam = torch.where(accept, torch.clamp_min(lam * 0.3, 1e-10), torch.clamp_max(lam * 5.0, 1e8))
        c_next = torch.where(accept, c_new, c_prev)
        rel = (c_prev - c_next).abs() / torch.clamp_min(c_prev, 1e-20)
        done = (~accept & (lam >= 1e8)) | (accept & (rel < 1e-12))
        c_prev = c_next
        it += 1
        if bool(done):
            break
    R = rodrigues(theta[:3]) @ R_init
    T = T0 + B @ theta[3:]
    return EpipolarPolishResult(R=R, T=T / torch.linalg.norm(T), initial_rms=torch.sqrt(c0 / n_eff),
                                final_rms=torch.sqrt(c_prev / n_eff), n_iters=it)


def polish_pose_f64(R_init, T_init, p0, p1, weights, max_iters=60):
    """Host float64 LM Sampson polish (5 dof) over fixed-weight matches,
    copied from the JAX package (numpy): a central-difference Jacobian
    over the 5-dof tangent, O(N) per iteration.  A genuine LK-refined
    match has a normalized Sampson residual of ~3e-6, at float32
    resolution, which floors the device polish near 1e-4 rad.

    Returns (R, T_unit, rms_before, rms_after) in float64; the weighted
    cost is monotone non-increasing, so the result never regresses."""
    R0 = np.asarray(R_init, np.float64)
    T0 = np.asarray(T_init, np.float64).reshape(3)
    T0 = T0 / np.linalg.norm(T0)
    a = np.array([1.0, 0, 0]) if abs(T0[0]) < 0.9 else np.array([0, 1.0, 0])
    b1 = np.cross(T0, a)
    b1 /= np.linalg.norm(b1)
    B = np.stack([b1, np.cross(T0, b1)], axis=-1)  # (3, 2)

    x0 = np.concatenate([np.asarray(p0, np.float64), np.ones((len(p0), 1))], -1)
    x1 = np.concatenate([np.asarray(p1, np.float64), np.ones((len(p1), 1))], -1)
    sw = np.sqrt(np.maximum(np.asarray(weights, np.float64), 0.0))
    n_eff = max(float((sw ** 2).sum()), 1.0)

    def rodr(w):
        th = np.linalg.norm(w)
        K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        if th < 1e-12:
            return np.eye(3) + K
        K /= th
        return np.eye(3) + np.sin(th) * K + (1.0 - np.cos(th)) * (K @ K)

    def residual(theta):
        R = rodr(theta[:3]) @ R0
        T = T0 + B @ theta[3:]
        T = T / np.linalg.norm(T)
        E = np.array([[0, -T[2], T[1]], [T[2], 0, -T[0]], [-T[1], T[0], 0]]) @ R
        Ex0 = x0 @ E.T
        Etx1 = x1 @ E
        num = np.sum(x1 * Ex0, -1)
        den = Ex0[:, 0] ** 2 + Ex0[:, 1] ** 2 + Etx1[:, 0] ** 2 + Etx1[:, 1] ** 2
        return sw * num / np.sqrt(den + 1e-300)

    def cost(theta):
        r = residual(theta)
        return float(r @ r)

    theta = np.zeros(5)
    lam = 1e-6
    c_prev = c0 = cost(theta)
    h = 1e-7
    for _ in range(max_iters):
        J = np.empty((len(x0), 5))
        for k in range(5):
            e = np.zeros(5)
            e[k] = h
            J[:, k] = (residual(theta + e) - residual(theta - e)) / (2 * h)
        r = residual(theta)
        Hm = J.T @ J
        g = J.T @ r
        ok = False
        for _ in range(8):
            try:
                dtheta = np.linalg.solve(Hm + lam * np.diag(np.diag(Hm) + 1e-300), g)
            except np.linalg.LinAlgError:
                lam *= 10
                continue
            c_new = cost(theta - dtheta)
            if c_new < c_prev:
                theta = theta - dtheta
                lam = max(lam * 0.3, 1e-12)
                rel = (c_prev - c_new) / max(c_prev, 1e-300)
                c_prev = c_new
                ok = True
                break
            lam = min(lam * 5.0, 1e10)
        if not ok or rel < 1e-14:
            break

    R = rodr(theta[:3]) @ R0
    T = T0 + B @ theta[3:]
    T = T / np.linalg.norm(T)
    return R, T, np.sqrt(c0 / n_eff), np.sqrt(c_prev / n_eff)
