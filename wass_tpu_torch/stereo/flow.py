"""Optical-flow reconstruction path on the card.

Counterpart of wass_tpu/stereo/flow.py, the reference's optional
WASS_ENABLE_OPTFLOW stage (`refine_flow`, wass_stereo.cpp:1391-1775): the
dense stage's rectified disparity becomes a coarse base -> match flow over
the undistorted base image (a gather through the rectifying homographies),
its holes are filled by iterated masked 3x3 averaging, a Horn-Schunck
variational solver refines it (outer warp iterations, inner Jacobi sweeps),
and the refined correspondences that pass the reference's gates are
triangulated into a second point cloud (mesh_full_flow.ply).

The solver's two steps are the CUDA kernels of stereo/flow_kernels.py
(csrc/flow.cu); the rest are torch ops on the device of the inputs.  The
3x3 homography products are written out elementwise (torch's CPU `@` picks
its BLAS kernel by the host), the box sums as shifted adds in one fixed
order, and the norms of the gates as XLA's chain of fused multiply-adds
(stereo/dense.py:fma32).  JAX's image gradients wrap around at the
borders (jnp.roll), and so do these.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from wass_tpu_torch.core.triangulate import triangulate_normalized
from wass_tpu_torch.ops.sampling import bilinear_sample, resize
from wass_tpu_torch.stereo import flow_kernels
from wass_tpu_torch.stereo.dense import fma32


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    """FLOW_* options (wass_stereo.cpp:78-83) under their reference
    semantics, plus the solver's iteration structure (the JAX package's
    FlowConfig, field for field)."""

    fullres_iterations: int = 200      # FLOW_REFINEMENT_FULLRES_ITERATIONS
    color_consistency: float = 100.0   # FLOW_REFINEMENT_COLOR_CONSISTENCY_FACTOR (delta)
    lowres_smoothness: float = 90.0    # FLOW_REFINEMENT_LOWRES_SMOOTHNESS_FACTOR (alpha)
    fullres_smoothness: float = 300.0  # FLOW_REFINEMENT_FULLRES_SMOOTHNESS_FACTOR
    opening_dilate: int = 1            # FLOW_OPENING_DILATE
    opening_erode: int = 1             # FLOW_OPENING_ERODE
    lowres_iterations: int = 1500      # fixed in the reference (:1704)
    inner_iterations: int = 25         # Jacobi sweeps per linearization
    idw_reps: int = 24                 # hole-fill passes (coarse flow)
    z_min: float = 1.0                 # accept gate on triangulated z (:1760)
    z_max: float = 100.0
    # The reference refines at 1/4 scale first (its coarse flow comes from
    # sparse correspondences); the stereo-seeded coarse flow is dense, so a
    # single full-resolution refinement is the default.  two_scale=True
    # runs the reference's schedule.
    two_scale: bool = False


def _grid(H: int, W: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xx, yy) float32 pixel coordinates, broadcastable to (H, W)."""
    xx = torch.arange(W, dtype=torch.float32, device=device)[None, :]
    yy = torch.arange(H, dtype=torch.float32, device=device)[:, None]
    return xx, yy


def _matrix(m, device) -> torch.Tensor:
    return torch.as_tensor(m, dtype=torch.float32, device=device)


# --------------------------------------------------------------------------
# Morphology on float masks (cv::dilate/erode 3x3, :1588-1589)
# --------------------------------------------------------------------------


def _shift2(x: torch.Tensor, dy: int, dx: int, fill: float) -> torch.Tensor:
    """Roll with the wrapped rows and columns reset to `fill` (the op's
    neutral element), so the morphology is exact at the borders."""
    x = torch.roll(x, (dy, dx), (0, 1))
    if dy > 0:
        x[:dy, :] = fill
    elif dy < 0:
        x[dy:, :] = fill
    if dx > 0:
        x[:, :dx] = fill
    elif dx < 0:
        x[:, dx:] = fill
    return x


def binary_dilate(mask: torch.Tensor, steps: int) -> torch.Tensor:
    for _ in range(steps):
        acc = mask
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                acc = torch.maximum(acc, _shift2(mask, dy, dx, 0.0))
        mask = acc
    return mask


def binary_erode(mask: torch.Tensor, steps: int) -> torch.Tensor:
    for _ in range(steps):
        acc = mask
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                acc = torch.minimum(acc, _shift2(mask, dy, dx, 1.0))
        mask = acc
    return mask


# --------------------------------------------------------------------------
# Coarse flow from the rectified disparity (gather formulation)
# --------------------------------------------------------------------------


def _apply_h(Hm: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Hm @ (x, y, 1), each row (h0 x + h1 y) + h2."""
    return [(Hm[i, 0] * x + Hm[i, 1] * y) + Hm[i, 2] for i in range(3)]


def coarse_flow_from_disparity(disp, H_base, Hi_match, out_shape, min_disp: float, valid_rect=None):
    """Dense coarse flow over the undistorted base image: for base pixel p,
    r = H_base p (rectified), d = disp(r), q = Hi_match (r - (d, 0));
    flow(p) = q - p.  Returns (flow (H, W, 2), valid (H, W)); valid_rect
    restricts the seeds to the dense stage's post-gate validity."""
    dev = disp.device
    H, W = out_shape
    Hr, Wr = disp.shape
    xx, yy = _grid(H, W, dev)
    xx, yy = xx.expand(H, W), yy.expand(H, W)
    r0, r1, r2 = _apply_h(_matrix(H_base, dev), xx, yy)
    rx = r0 / r2
    ry = r1 / r2
    d = bilinear_sample(disp, rx, ry, fill=0.0)
    okmap = disp > min_disp
    if valid_rect is not None:
        okmap = okmap & valid_rect
    ok = bilinear_sample(okmap.to(torch.float32), rx, ry, fill=0.0)
    inb = (rx >= 0) & (rx <= Wr - 1) & (ry >= 0) & (ry <= Hr - 1)
    valid = (ok > 0.999) & inb & (d > min_disp)
    m0, m1, m2 = _apply_h(_matrix(Hi_match, dev), rx - d, ry)
    flow = torch.stack([m0 / m2 - xx, m1 / m2 - yy], -1)
    return torch.where(valid[..., None], flow, 0.0), valid


def box3(x: torch.Tensor) -> torch.Tensor:
    """3x3 box sum, zero-padded like a "SAME" convolution, the taps added row
    by row, left to right."""
    H, W = x.shape
    p = F.pad(x, (1, 1, 1, 1))
    acc = p[0:H, 0:W]
    for dy, dx in ((0, 1), (0, 2), (1, 0), (1, 1), (1, 2), (2, 0), (2, 1), (2, 2)):
        acc = acc + p[dy:dy + H, dx:dx + W]
    return acc


def idw_fill(flow: torch.Tensor, valid: torch.Tensor, reps: int = 24) -> torch.Tensor:
    """Fill invalid flow pixels by iterated masked 3x3 averaging (each pass
    grows the support by one pixel)."""
    f0 = flow[..., 0] * valid
    f1 = flow[..., 1] * valid
    m = valid.to(torch.float32)
    for _ in range(reps):
        den = box3(m)
        scale = torch.clamp_min(den, 1e-6)
        fill0 = box3(f0) / scale
        fill1 = box3(f1) / scale
        known = m > 0
        f0 = torch.where(known, f0, fill0)
        f1 = torch.where(known, f1, fill1)
        m = torch.maximum(m, (den > 0).to(torch.float32))
    return torch.stack([f0, f1], -1)


# --------------------------------------------------------------------------
# Variational refinement (Horn-Schunck fixed point with warping)
# --------------------------------------------------------------------------


def _image_grads(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Central differences that wrap around at the borders (jnp.roll)."""
    gx = (torch.roll(img, -1, 1) - torch.roll(img, 1, 1)) * 0.5
    gy = (torch.roll(img, -1, 0) - torch.roll(img, 1, 0)) * 0.5
    return gx, gy


def smoothness_ratio(alpha: float, delta: float) -> float:
    """lam = alpha / max(delta, 1e-6) in float32, as the jitted JAX solver
    divides its traced float32 scalars."""
    return float(np.float32(alpha) / np.maximum(np.float32(delta), np.float32(1e-6)))


def variational_refine(I0, I1, flow, alpha: float, delta: float, outer: int, inner: int) -> torch.Tensor:
    """Refine flow so that I1(p + flow(p)) ~ I0(p).

    Energy (cv::VariationalRefinement semantics, gamma = 0):
      E = sum delta * rho(I1(p + w) - I0(p)) + alpha * |grad w|^2
    with the Charbonnier rho.  Each of the `outer` iterations re-warps and
    linearises the data term at the warp point (u0, v0) (flow_linearize),
    then `inner` Jacobi sweeps (flow_jacobi) update the flow.  Three (u, v)
    buffers rotate: the sweeps alternate between the two that do not hold
    the warp point, and the last one written is the next warp point.
    I0, I1 (H, W) float32, flow (H, W, 2) -> (H, W, 2)."""
    lam = smoothness_ratio(alpha, delta)
    I0, I1 = I0.contiguous(), I1.contiguous()
    u, v = (flow[..., c].clone(memory_format=torch.contiguous_format) for c in range(2))
    spare = [(torch.empty_like(u), torch.empty_like(v)) for _ in range(2)]
    g1x, g1y = _image_grads(I1)
    for _ in range(outer):
        u0, v0 = u, v
        It, Ix, Iy, wdata = flow_kernels.flow_linearize(I0, I1, g1x, g1y, u0, v0)
        for k in range(inner):
            u, v = flow_kernels.flow_jacobi(u, v, u0, v0, It, Ix, Iy, wdata, lam, out=spare[k % 2])
        if inner:
            spare[(inner - 1) % 2] = (u0, v0)
    return torch.stack([u, v], -1)


def refine_flow_two_scale(I0, I1, flow, cfg: FlowConfig) -> torch.Tensor:
    """The reference's two-scale schedule (wass_stereo.cpp:1709-1738):
    quarter-resolution refinement with `lowres_smoothness`, upsample x4,
    full-resolution refinement with `fullres_smoothness`."""
    H, W = I0.shape
    h4, w4 = max(H // 4, 8), max(W // 4, 8)
    I0s = resize(I0, (h4, w4), interp="linear")
    I1s = resize(I1, (h4, w4), interp="linear")
    sy = h4 / H
    sx = w4 / W
    fs = torch.stack([resize(flow[..., 0], (h4, w4), interp="linear") * sx,
                      resize(flow[..., 1], (h4, w4), interp="linear") * sy], -1)
    outer_low = max(1, cfg.lowres_iterations // (cfg.inner_iterations * 4))
    fs = variational_refine(I0s, I1s, fs, cfg.lowres_smoothness, cfg.color_consistency, outer=outer_low,
                            inner=cfg.inner_iterations)
    flow_up = torch.stack([resize(fs[..., 0].contiguous(), (H, W), interp="linear") / sx,
                           resize(fs[..., 1].contiguous(), (H, W), interp="linear") / sy], -1)
    outer_full = max(1, cfg.fullres_iterations // cfg.inner_iterations)
    return variational_refine(I0, I1, flow_up, cfg.fullres_smoothness, cfg.color_consistency, outer=outer_full,
                              inner=cfg.inner_iterations)


# --------------------------------------------------------------------------
# Correspondence gates + triangulation (flow_to_points, :1507-1556)
# --------------------------------------------------------------------------


def norm2(f: torch.Tensor) -> torch.Tensor:
    """|f| over the last axis of size 2 in XLA's compiled order: the squares
    summed by a chain of fused multiply-adds."""
    return torch.sqrt(fma32(f[..., 1], f[..., 1], f[..., 0] * f[..., 0]))


def flow_correspondence_gates(flow, mask, I_base, I_match) -> torch.Tensor:
    """The reference's per-pixel acceptance gates: finite flow, magnitude
    < W/2, opened mask, target inside the match image, both intensities
    nonzero."""
    H, W = I_base.shape
    xx, yy = _grid(H, W, flow.device)
    qx = xx + flow[..., 0]
    qy = yy + flow[..., 1]
    mag = norm2(flow)
    ok = torch.isfinite(mag) & (mag < W / 2) & (mask > 0)
    ok = ok & (qx > 0) & (qx < W) & (qy > 0) & (qy < H)
    match_at = bilinear_sample(I_match, qx, qy, fill=0.0)
    return ok & (I_base > 0) & (match_at > 0)


def triangulate_flow(flow, valid, K0, K1, R, T, base_is_cam0: bool, cfg: FlowConfig):
    """Triangulate base -> match flow correspondences: cam0-frame points
    (H, W, 3) and their validity under the reference's z gates
    (:1758-1761)."""
    dev = flow.device
    H, W = valid.shape
    K0, K1, R, T = (_matrix(m, dev) for m in (K0, K1, R, T))
    xx, yy = _grid(H, W, dev)
    uv_base = torch.stack([xx.expand(H, W), yy.expand(H, W)], -1)
    uv_match = uv_base + flow
    uv0, uv1 = (uv_base, uv_match) if base_is_cam0 else (uv_match, uv_base)
    p = torch.stack([(uv0[..., 0] - K0[0, 2]) / K0[0, 0], (uv0[..., 1] - K0[1, 2]) / K0[1, 1]], -1)
    q = torch.stack([(uv1[..., 0] - K1[0, 2]) / K1[0, 0], (uv1[..., 1] - K1[1, 2]) / K1[1, 1]], -1)
    pts = triangulate_normalized(p, q, R, T)
    return pts, valid & (pts[..., 2] >= cfg.z_min) & (pts[..., 2] <= cfg.z_max)


# --------------------------------------------------------------------------
# One frame
# --------------------------------------------------------------------------


@dataclasses.dataclass
class FlowResult:
    flow: torch.Tensor         # (H, W, 2) refined base -> match flow
    coarse_flow: torch.Tensor  # (H, W, 2) the flow before the refinement
    points: torch.Tensor       # (H, W, 3) cam0-frame triangulated points
    valid: torch.Tensor        # (H, W) bool


def flow_reconstruct_frame(disp, base_img, match_img, geom, cfg: FlowConfig = FlowConfig(), min_disp: float = 1.0,
                           valid_rect=None, max_refine_deviation: float = 4.0) -> FlowResult:
    """The flow stage of one frame (refine_flow, wass_stereo.cpp:1580-1773),
    on the device of `disp`.

    disp: the rectified disparity (H, W) tensor; base_img/match_img: the
    undistorted base and match images (tensors or arrays; float32 is used),
    the flow working in unrectified space like the reference; geom: the
    frame's FrameGeometry; valid_rect: the dense stage's validity map,
    restricting the coarse correspondences to post-gate pixels;
    max_refine_deviation: pixels whose refined flow moved farther than this
    from the stereo-seeded coarse flow are dropped (drift in textureless
    areas).  The fields of the result stay on the device."""
    dev = disp.device
    disp = disp.to(torch.float32)
    I0, I1 = (torch.as_tensor(img, device=dev).to(torch.float32).contiguous() for img in (base_img, match_img))
    H, W = I0.shape
    flow, valid = coarse_flow_from_disparity(disp, geom.H_base, geom.Hi_match, (H, W), min_disp,
                                             valid_rect=None if valid_rect is None else valid_rect.to(dev))
    mask = binary_erode(binary_dilate(valid.to(torch.float32), cfg.opening_dilate), cfg.opening_erode)
    coarse = idw_fill(flow, valid, reps=cfg.idw_reps)
    if cfg.two_scale:
        refined = refine_flow_two_scale(I0, I1, coarse, cfg)
    else:
        outer = max(1, cfg.fullres_iterations // cfg.inner_iterations)
        refined = variational_refine(I0, I1, coarse, cfg.fullres_smoothness, cfg.color_consistency, outer=outer,
                                     inner=cfg.inner_iterations)
    ok = flow_correspondence_gates(refined, mask, I0, I1)
    ok = ok & (norm2(refined - coarse) <= max_refine_deviation)
    pts, ok = triangulate_flow(refined, ok, geom.K0, geom.K1, geom.R, geom.T, bool(geom.base_is_cam0), cfg)
    return FlowResult(flow=refined, coarse_flow=coarse, points=pts, valid=ok)
