"""The dense stereo stage: rectify -> census/SGM -> filter -> triangulate ->
z-gap outliers -> plane -> .xyzC payload.

Counterpart of wass_tpu/stereo/dense.py.  Conventions are the
reference's: cameras cam0 / cam1 with x_c1 = R x_c0 + T, outputs in the
cam0 frame, T rescaled to a baseline norm of cam_distance; base is the
rectified image whose grid is iterated, match is sampled at x - d.

Host geometry is float64 numpy; everything per pixel runs on the device of
the input tensors.  The disparity takes the branch the JAX package's
production pipeline takes on its accelerator: the coarse-to-fine windowed
search (stereo/c2f.py: K1 + K3 at 1/4 resolution, then K2 + K4, or K2 + K6
for 2 paths) when the shapes conform, the full-range one (K1 + K3, or
K1 + K5 for 2/4 paths and the left-right check) otherwise or when the
coarse windows miss too much.  The component labels run K7.  On CUDA
tensors these are the hand-written kernels, on CPU tensors their plain
versions.  A frame is three parts: `DenseStereoPipeline.device_part`, the
device work up to the plane's covariance; the plane's normal from its one
host read (plane.read, `plane_normal_read`); and `tail`, the plane and
its final crop on the device.  The frame's .xyzC export (export_frame:
the u16 payload rows and a float64 header) reads nothing on the host
either.  On a card the sequence loop replays the device parts, the
export and the rectification from CUDA graphs (stereo/frame_graphs.py).
Inside a recorder's scope (instrument.py) the frame's stages are spans:
dense.frame around the census (dense.census), the disparity search
(dense.disparity), the postprocess, triangulation and z-gap components
(dense.post) and the plane (dense.plane).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from wass_tpu_torch.core.geometry import homogeneous_transform, rt_from_plane
from wass_tpu_torch.core.rectify import stereo_rectify_homographies
from wass_tpu_torch.core.triangulate import triangulate_normalized
from wass_tpu_torch.device import to_device
from wass_tpu_torch.instrument import host_read, span
from wass_tpu_torch.ops.components import biggest_component_mask, zgap_component_mask
from wass_tpu_torch.ops.morphology import dilate_zero, erode_zero, median_filter, sobel
from wass_tpu_torch.ops.sampling import resize, warp_homography
from wass_tpu_torch.stereo import sgm_kernels
from wass_tpu_torch.stereo.c2f import c2f_supported, coarse_disparity, compute_row_windows, windowed_disparity
from wass_tpu_torch.stereo.plane import (
    PlaneFit,
    crop_plane,
    plane_covariance,
    plane_from_normal,
    plane_normal,
    ransac_find_plane,
)
from wass_tpu_torch.stereo.sgm import sgm_disparity_census


@dataclasses.dataclass(frozen=True)
class DenseStereoConfig:
    """Static configuration: the fields and defaults of
    wass_tpu.stereo.dense.DenseStereoConfig (see there for each field's
    provenance).  c2f_window > 0 enables the coarse-to-fine search on any
    device where the shapes conform (_c2f_active).  use_pallas names the
    TPU kernels and is ignored: on CUDA the port always runs its own
    kernels."""

    num_disp: int = 256
    min_disp: int = 1
    p1: int = 8
    p2: int = 96
    directions: int = 8
    census_win: Tuple[int, int] = (7, 9)
    uniqueness_ratio: int = 1
    lr_max_diff: int = -1
    dense_scale: float = 1.0
    disp_dilate_steps: int = 1
    disp_erosion_steps: int = 2
    median_filter_wsize: int = 0
    biggest_component_grad_threshold: float = 0.0  # 0 disables
    min_angle_deg: float = 20.0
    cam_distance: float = 1.0
    discard_burned: bool = True
    zgap_percentile: float = 99.0
    plane_ransac_rounds: int = 400
    plane_ransac_threshold: float = 1.0
    plane_max_distance: float = 1.5
    plane_refine_max_distance: float = 70.0
    plane_weight_by_distance: bool = True
    min_triangulated: int = 100
    random_seed: int = 0
    use_pallas: bool = True
    c2f_window: int = 128
    c2f_factor: int = 4
    c2f_min_coverage: float = 0.5
    c2f_max_offband: float = 2e-3
    # Negative = AUTO: resolved per sequence from the input degradation
    # (prepare/degradation.py); at the census level it means 0.8.
    input_smooth_sigma: float = -1.0


class DenseFrameResult(NamedTuple):
    points: torch.Tensor  # (H, W, 3) cam0-frame points on the base grid
    valid: torch.Tensor  # (H, W) final validity mask
    plane: torch.Tensor  # (4,) refined plane in cam0 frame (nan if not ok)
    plane_ok: torch.Tensor  # bool
    disparity: torch.Tensor  # (H, W) filtered disparity
    n_points: torch.Tensor  # valid points after outlier removal and crop
    fail_reasons: Optional[torch.Tensor] = None  # (H, W) uint8 FAIL_* codes


# Per-pixel triangulation failure codes (the reference's color-coded
# debug map, wass_stereo.cpp:1115-1120).
FAIL_OK = 0
FAIL_NO_DISPARITY = 1
FAIL_OUTSIDE_IMAGE = 2
FAIL_OUTSIDE_BBOX = 3
FAIL_BURNED = 4
FAIL_ANGLE = 5
FAIL_TOO_CLOSE = 6
FAIL_TOO_DISTANT = 7


# --------------------------------------------------------------------------
# Host-side geometry
# --------------------------------------------------------------------------


@dataclasses.dataclass
class FrameGeometry:
    """Per-frame rectification data (host, float64)."""

    H_base: np.ndarray
    H_match: np.ndarray
    Hi_base: np.ndarray
    Hi_match: np.ndarray
    roi: Tuple[int, int, int, int]
    base_is_cam0: bool
    R: np.ndarray  # cam0 -> cam1, baseline-normalized
    T: np.ndarray
    K0: np.ndarray
    K1: np.ndarray


def prepare_frame_geometry(K0, K1, R, T, image_size, cam_distance: float = 1.0) -> FrameGeometry:
    """Baseline normalization + base/match role selection + rectifying
    homographies (image_size is (width, height))."""
    R = np.asarray(R, np.float64)
    T = np.asarray(T, np.float64).reshape(3)
    T = T / np.linalg.norm(T) * cam_distance
    C1_in_0 = -R.T @ T  # cam1 centre in the cam0 frame
    base_is_cam0 = bool(C1_in_0[0] > 0)
    if base_is_cam0:
        res = stereo_rectify_homographies(K0, K1, R.T, C1_in_0, image_size)
    else:
        res = stereo_rectify_homographies(K1, K0, R, T, image_size)
    return FrameGeometry(
        H_base=res.HL,
        H_match=res.HR,
        Hi_base=np.linalg.inv(res.HL),
        Hi_match=np.linalg.inv(res.HR),
        roi=res.roi,
        base_is_cam0=base_is_cam0,
        R=R,
        T=T,
        K0=np.asarray(K0, np.float64),
        K1=np.asarray(K1, np.float64),
    )


def build_geom_pack(geom: FrameGeometry, image_shape, device) -> dict:
    """Device-side geometry bundle (float32 matrices, the ROI mask)."""
    H, W = image_shape
    rx, ry, rw, rh = geom.roi
    yy, xx = np.mgrid[0:H, 0:W]
    roi_mask = (xx >= rx) & (xx < rx + rw) & (yy >= ry) & (yy < ry + rh)
    if geom.base_is_cam0:
        R_mb, T_mb = geom.R.T, -geom.R.T @ geom.T
    else:
        R_mb, T_mb = geom.R, geom.T

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return {
        "H_base": f32(geom.H_base),
        "H_match": f32(geom.H_match),
        "Hi_base": f32(geom.Hi_base),
        "Hi_match": f32(geom.Hi_match),
        "K0": f32(geom.K0),
        "K1": f32(geom.K1),
        "R": f32(geom.R),
        "T": f32(geom.T),
        "R_mb": f32(R_mb),
        "T_mb": f32(T_mb),
        "base_is_cam0": bool(geom.base_is_cam0),
        "roi_mask": torch.as_tensor(roi_mask, device=device),
    }


def rectify_on_device(img: torch.Tensor, Hm, out_shape) -> torch.Tensor:
    """Rectification warp (cv::warpPerspective with linear interpolation).
    Hm: the float64 host homography, or its float32 copy on img's device
    (the geometry pack's H_base / H_match), which spares a host-to-device
    copy that waits for the stream."""
    if not isinstance(Hm, torch.Tensor):
        Hm = torch.as_tensor(np.asarray(Hm, np.float32), device=img.device)
    return warp_homography(img, Hm, out_shape)


def rectify_pair(b8: torch.Tensor, m8: torch.Tensor, geom_pack: dict, out_shape):
    """The rectified base and match images from the uploaded (uint8) pair,
    cast to float32 on the device."""
    return (rectify_on_device(b8.to(torch.float32), geom_pack["H_base"], out_shape),
            rectify_on_device(m8.to(torch.float32), geom_pack["H_match"], out_shape))


# --------------------------------------------------------------------------
# Device-side stages
# --------------------------------------------------------------------------


def disparity_postprocess(disp: torch.Tensor, cfg: DenseStereoConfig) -> torch.Tensor:
    """The reference's disparity cleanup chain: zero-aware dilate / erode,
    optional scale-up, optional median, optional biggest component."""
    for _ in range(cfg.disp_dilate_steps):
        disp = dilate_zero(disp)
    for _ in range(cfg.disp_erosion_steps):
        disp = erode_zero(disp)
    if cfg.dense_scale != 1.0:
        H, W = disp.shape
        full = (round(H / cfg.dense_scale), round(W / cfg.dense_scale))
        nn = erode_zero(resize(disp, full, interp="nearest"))
        cub = resize(disp, full, interp="cubic")
        disp = torch.where(nn == 0, 0.0, cub) / cfg.dense_scale
    if cfg.median_filter_wsize >= 3:
        disp = median_filter(disp, cfg.median_filter_wsize)
    if cfg.biggest_component_grad_threshold > 0:
        gx = sobel(disp, 0)
        gy = sobel(disp, 1)
        disp = torch.where(gx * gx + gy * gy > cfg.biggest_component_grad_threshold, 0.0, disp)
        disp = torch.where(biggest_component_mask(disp != 0), disp, 0.0)
    return disp


def burned_match_mask(disp: torch.Tensor, bm: torch.Tensor, min_disp: int, num_disp: int) -> torch.Tensor:
    """burned[y, x] = bm[y, x - round(disp[y, x])] for a rounded disparity in
    [min_disp, min_disp + num_disp) with x - d >= 0 (round half to even)."""
    W = bm.shape[1]
    di = torch.round(disp).to(torch.int64)
    xs = torch.arange(W, device=disp.device)[None, :] - di
    ok = (di >= min_disp) & (di < min_disp + num_disp) & (xs >= 0)
    return torch.gather(bm, 1, xs.clamp(0, W - 1)) & ok


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def triangulate_dense(disp, geom_pack: dict, base_rect, match_rect, cfg: DenseStereoConfig):
    """Per-pixel triangulation with the reference's validity gates
    (wass_stereo.cpp:1173-1373).  Returns (points (H, W, 3), valid (H, W),
    failure codes (H, W) uint8)."""
    H, W = disp.shape
    dev = disp.device
    yy, xx = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev),
        torch.arange(W, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    # The codes enter as Python scalars: a code tensor made on the device
    # would be a host-to-device copy that waits for the stream.
    valid = disp > cfg.min_disp
    reasons = torch.full(disp.shape, FAIL_NO_DISPARITY, dtype=torch.uint8, device=dev).masked_fill_(valid, FAIL_OK)
    roi = geom_pack["roi_mask"]
    valid = valid & roi
    reasons = torch.where(~roi, FAIL_OUTSIDE_BBOX, reasons)

    xm = xx - disp  # match-image x
    in_match = (xm >= 0) & (xm < W)
    valid = valid & in_match
    reasons = torch.where(~in_match, FAIL_OUTSIDE_BBOX, reasons)

    uv_base = homogeneous_transform(geom_pack["Hi_base"], torch.stack([xx, yy], -1))
    uv_match = homogeneous_transform(geom_pack["Hi_match"], torch.stack([xm, yy], -1))
    for uv in (uv_base, uv_match):  # in-image gates, 1 px margin
        in_img = (uv[..., 0] >= 1) & (uv[..., 0] < W - 1) & (uv[..., 1] >= 1) & (uv[..., 1] < H - 1)
        valid = valid & in_img
        reasons = torch.where(~in_img, FAIL_OUTSIDE_IMAGE, reasons)

    if cfg.discard_burned:
        # Saturation tested on the rectified images (DISCARD_BURNED_AREAS).
        burned_base = base_rect > 254.0
        valid = valid & ~burned_base
        burned = burned_match_mask(disp, match_rect > 254.0, cfg.min_disp, cfg.num_disp)
        valid = valid & ~burned
        reasons = torch.where(burned_base | burned, FAIL_BURNED, reasons)

    K0, K1 = geom_pack["K0"], geom_pack["K1"]
    base_is_cam0 = geom_pack["base_is_cam0"]
    uv0, uv1 = (uv_base, uv_match) if base_is_cam0 else (uv_match, uv_base)
    p = torch.stack([(uv0[..., 0] - K0[0, 2]) / K0[0, 0], (uv0[..., 1] - K0[1, 2]) / K0[1, 1]], -1)
    q = torch.stack([(uv1[..., 0] - K1[0, 2]) / K1[0, 0], (uv1[..., 1] - K1[1, 2]) / K1[1, 1]], -1)

    # Angle gate (:1257-1269), reproduced literally: d1 = normalize([p_match, 1]),
    # d2 = normalize(R_mb [q_base, 1] + T_mb).
    p_match, q_base = (q, p) if base_is_cam0 else (p, q)
    R_mb, T_mb = geom_pack["R_mb"], geom_pack["T_mb"]
    one = torch.ones_like(p_match[..., :1])
    d1 = torch.cat([p_match, one], -1)
    d1 = d1 / torch.sqrt(_dot3(d1, d1))[..., None]
    qb = torch.cat([q_base, one], -1)
    d2 = torch.stack([_dot3(qb, R_mb[i]) + T_mb[i] for i in range(3)], -1)
    d2 = d2 / torch.sqrt(_dot3(d2, d2))[..., None]
    ang = torch.rad2deg(torch.arccos(torch.clamp(_dot3(d1, d2), -1.0, 1.0)))
    if cfg.min_angle_deg > 0:
        ang_ok = ang.abs() >= cfg.min_angle_deg
        valid = valid & ang_ok
        reasons = torch.where(~ang_ok, FAIL_ANGLE, reasons)

    pts = triangulate_normalized(p, q, geom_pack["R"], geom_pack["T"])

    # Distance gates (:1327-1340), only on pixels that reached triangulation.
    dist = torch.sqrt(_dot3(pts, pts))
    too_close = (dist < cfg.cam_distance / 10.0) | (pts[..., 2] < 1.0)
    too_far = (dist > cfg.cam_distance * 200.0) | ~(pts[..., 2] < 1e30)
    ok = reasons == FAIL_OK
    reasons = torch.where(ok & too_close, FAIL_TOO_CLOSE, reasons)
    reasons = torch.where((reasons == FAIL_OK) & too_far, FAIL_TOO_DISTANT, reasons)
    valid = valid & ~too_close & ~too_far
    return pts, valid, reasons


def _masked_percentile_bisect(values: torch.Tensor, mask: torch.Tensor, pct: float, iters: int = 20) -> torch.Tensor:
    """Approximate masked percentile: 20 bisection steps on the value axis,
    each one masked count (the reference's rule, not an exact quantile)."""
    total = torch.clamp_min(mask.sum(), 1)
    target = (pct / 100.0) * total
    hi = torch.where(mask, values, 0.0).max()
    lo = torch.zeros_like(hi)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        below = (mask & (values <= mid)).sum() < target
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    return hi


def outlier_removal(pts: torch.Tensor, valid: torch.Tensor, cfg: DenseStereoConfig):
    """Z-gap percentile + biggest z-gap-gated component
    (PovMesh.cpp:888-987).  Returns (keep mask, z-gap threshold)."""
    z = pts[..., 2]
    gaps, masks = [], []
    for dx in (-1, 0, 1):  # up-left, up, up-right neighbours
        m = valid & torch.roll(valid, (1, -dx), (0, 1))
        m[0, :] = False
        if dx == -1:
            m[:, -1] = False
        elif dx == 1:
            m[:, 0] = False
        gaps.append((z - torch.roll(z, (1, -dx), (0, 1))).abs())
        masks.append(m)
    zgap = _masked_percentile_bisect(torch.stack(gaps), torch.stack(masks), cfg.zgap_percentile)
    return zgap_component_mask(z, valid, zgap), zgap


class PlaneParts(NamedTuple):
    """plane_stage's device part: RANSAC's fit, the validity before and
    after its crop, and the refinement's covariance and centroid."""

    fit: PlaneFit
    valid: torch.Tensor
    valid_c: torch.Tensor
    A: torch.Tensor
    centroid: torch.Tensor


def plane_stage_device(pts: torch.Tensor, valid: torch.Tensor, cfg: DenseStereoConfig,
                       uv: Optional[torch.Tensor] = None) -> PlaneParts:
    """RANSAC -> crop -> the refinement's covariance, on the device."""
    fit = ransac_find_plane(
        pts, valid, cfg.plane_ransac_rounds, cfg.plane_ransac_threshold, seed=cfg.random_seed, uv=uv
    )
    valid_c = crop_plane(fit.plane, pts, valid, cfg.plane_ransac_threshold)
    A, centroid = plane_covariance(pts, valid_c, cfg.plane_refine_max_distance, cfg.plane_weight_by_distance)
    return PlaneParts(fit, valid, valid_c, A, centroid)


def plane_stage_tail(pts: torch.Tensor, parts: PlaneParts, n: torch.Tensor, cfg: DenseStereoConfig):
    """The refined plane from its normal n (plane_normal's, on the points'
    device), then the final crop.  Returns (plane (nan when the fit
    failed), plane_ok, valid)."""
    fit = parts.fit
    plane = plane_from_normal(n, parts.centroid)
    valid_f = torch.where(fit.ok, crop_plane(plane, pts, parts.valid, cfg.plane_max_distance), parts.valid_c)
    return torch.where(fit.ok, plane, torch.full_like(plane, float("nan"))), fit.ok, valid_f


def plane_normal_read(parts: PlaneParts, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plane's normal from its covariance read on the host, into `out`
    where given: the frame's one host read on the dispatching thread
    (plane.read; the plane parity with the reference rests on these float
    bits).  On a card `out` is pinned: a read into pageable memory holds
    the CUDA driver while it waits for the device, and the writers' CUDA
    calls would wait with it."""
    return plane_normal(host_read(parts.A, "plane.read", out))


def plane_stage(pts: torch.Tensor, valid: torch.Tensor, cfg: DenseStereoConfig, uv: Optional[torch.Tensor] = None):
    """RANSAC -> crop -> refine -> final crop: the device part, the normal
    from the host read, the tail.  Returns (plane (nan when the fit
    failed), plane_ok, valid)."""
    parts = plane_stage_device(pts, valid, cfg, uv)
    return plane_stage_tail(pts, parts, to_device(plane_normal_read(parts), pts.device), cfg)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once, as a fused multiply-add, with the
    same bits on every host and device.  The product is exact in float64,
    and the float64 sum s is first rounded to odd, with TwoSum's error as
    the sticky bit; then rounding to float32 rounds the exact value once,
    float32 ties and values below its normal range included.  Where s is
    no float32 tie the step to odd changes nothing: an even s that is no
    tie has odd neighbours, which are no ties either.  So every element
    takes the step and nothing is read on the host."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    fix = (err != 0) & torch.isfinite(err) & ((s.view(torch.int64) & 1) == 0)
    s = torch.where(fix, torch.nextafter(s, torch.copysign(torch.full_like(s, float("inf")), err)), s)
    return s.float()


def plane_frame(pts: torch.Tensor, Rp: torch.Tensor, Tp: torch.Tensor) -> torch.Tensor:
    """(..., 3) points -> (N, 3) in the sea-plane frame, p = Rp pts + Tp,
    in the order of the reference's compiled export (wass_tpu/stereo/dense.py
    _stage_export: XLA's CPU dot accumulates x r0, then y r1 and z r2 with
    fused multiply-adds, and adds Tp after).  Written out elementwise, so no
    BLAS kernel choice moves a bit: the truncating u16 cast of the export
    is sensitive to the last bit of p."""
    P = pts.reshape(-1, 3)
    acc = P[:, 0:1] * Rp[:, 0]
    acc = fma32(P[:, 1:2], Rp[:, 1], acc)
    acc = fma32(P[:, 2:3], Rp[:, 2], acc)
    return acc + Tp


def export_u16(pts: torch.Tensor, valid: torch.Tensor, plane: torch.Tensor, n_points: Optional[int] = None):
    """The .xyzC payload on the device: valid points in the sea-plane frame,
    quantized to u16 fixed point (scale = 65535 / range, clip, truncate)
    and compacted in scan order, as the reference's _stage_export: the
    running count of the valid mask scatters each point into a full
    (H*W, 3) buffer, so nothing waits for the device until the caller
    slices the first n_points rows (read from `valid` when not given).
    Returns (q (n, 3) int32, mins (3,) f32, scales (3,) f32); the host
    casts q to uint16."""
    Rp, Tp, _Rinv, _Tinv = rt_from_plane(plane)
    p = plane_frame(pts, Rp, Tp)
    fv = valid.reshape(-1)
    big = 1e30
    mins = torch.where(fv[:, None], p, big).amin(0)
    maxs = torch.where(fv[:, None], p, -big).amax(0)
    rngs = torch.where(maxs - mins > 0, maxs - mins, 1.0)
    # A tensor numerator: torch computes 65535.0 / rngs as reciprocal(rngs) *
    # 65535, an ulp off the float32 quotient that XLA computes.
    scales = torch.full_like(rngs, 65535.0) / rngs
    q = torch.clamp((p - mins) * scales, 0.0, 65535.0).to(torch.int32)
    HW = fv.shape[0]
    target = torch.where(fv, torch.cumsum(fv, 0) - 1, HW)  # invalid rows land in row HW, dropped
    out = torch.zeros((HW + 1, 3), dtype=torch.int32, device=q.device).index_copy_(0, target, q)
    if n_points is None:
        n_points = int(fv.sum())
    return out[:n_points], mins, scales


def u16_bits(q: torch.Tensor) -> torch.Tensor:
    """int32 values in [0, 65535] as int16 with the same low 16 bits, on
    their device, so 2 bytes a value cross the link."""
    return torch.where(q > 32767, q - 65536, q).to(torch.int16)


def fetch_u16(q: torch.Tensor) -> np.ndarray:
    """(n, 3) int32 values in [0, 65535] (export_u16's q) as uint16 on the
    host: cast to int16 bits on the device, so 2 bytes a value cross the
    link (6 a point), as the JAX package's u16 buffer."""
    return u16_bits(q).cpu().numpy().view(np.uint16)


# The fields of export_frame's float64 header and where each lies.
HEADER = {"n_points": 0, "plane_ok": 1, "plane": slice(2, 6), "mins": slice(6, 9), "scales": slice(9, 12),
          "coverage": 12, "offband": 13}
HEADER_LEN = 14


class FrameExport(NamedTuple):
    """A frame's .xyzC export on its device (export_frame)."""

    payload: torch.Tensor  # (H*W + 1, 3) int16: the u16 bits of the rows, the first n_points the file's
    header: torch.Tensor  # (HEADER_LEN,) float64, laid out as HEADER


def export_frame(res: DenseFrameResult, c2f: Optional[dict] = None, rows=export_u16) -> FrameExport:
    """The frame's .xyzC export on the device of its result, with no host
    read and shapes fixed by the frame's, so that a CUDA graph can hold it
    (graph F, stereo/frame_graphs.py): `rows` (export_u16, or a function of
    its signature) over the whole (H*W + 1, 3) buffer, cast to int16 bits
    as fetch_u16 casts, and the header: the point count, plane_ok, the
    plane, mins, scales and the coverage and offband of `c2f` (the frame's
    last_c2f; nan where it is None).  Each is a float32, a bool or a count
    below 2^53, so float64 holds it exactly.  The payload rows of an
    unusable plane are not the file's: the writer does not read them."""
    q, mins, scales = rows(res.points, res.valid, res.plane, res.valid.numel() + 1)
    if c2f is None:
        diag = torch.full((2,), float("nan"), dtype=torch.float64, device=q.device)
    else:
        diag = torch.stack([torch.as_tensor(c2f[k], dtype=torch.float64, device=q.device)
                            for k in ("coverage", "offband")])
    header = torch.cat([res.n_points.reshape(1).double(), res.plane_ok.reshape(1).double(), res.plane.double(),
                        mins.double(), scales.double(), diag])
    return FrameExport(u16_bits(q), header)


def unpack_header(h: np.ndarray) -> dict:
    """export_frame's header on the host by field (HEADER): n_points an
    int, plane_ok a bool, the rest float64, copied out of `h` (a buffer
    that the next read may overwrite)."""
    h = np.array(h, dtype=np.float64)
    out = {k: h[at] for k, at in HEADER.items()}
    out["n_points"], out["plane_ok"] = int(out["n_points"]), bool(out["plane_ok"])
    return out


def _c2f_active(cfg: DenseStereoConfig, shape) -> bool:
    """The coarse-to-fine branch runs when it is enabled and the (dense_scale
    scaled) shapes conform.  A shape gate only: the JAX package also asks
    for a TPU because its windowed kernels exist only there, while the
    port's kernels have plain versions for CPU tensors."""
    if cfg.c2f_window <= 0:
        return False
    H, W = shape
    if cfg.dense_scale != 1.0:
        H, W = round(H * cfg.dense_scale), round(W * cfg.dense_scale)
    return c2f_supported(H, W, cfg.num_disp, cfg.c2f_window, cfg.c2f_factor, cfg.directions, cfg.lr_max_diff)


def c2f_should_fallback(coverage: float, offband: float, cfg: DenseStereoConfig) -> bool:
    """Full-range fallback decision for one frame (host side)."""
    return coverage < cfg.c2f_min_coverage or offband > cfg.c2f_max_offband


class FrameParts(NamedTuple):
    """A dense frame's device work up to the plane's host read
    (DenseStereoPipeline.device_part), the input of its finish."""

    points: torch.Tensor
    reasons: torch.Tensor
    disparity: torch.Tensor
    plane: PlaneParts
    c2f: Optional[dict]  # the frame's last_c2f


class DenseStereoPipeline:
    """One dense frame on the device of its inputs: census x2, disparity
    (the c2f or full-range branch, see the module docstring), postprocess,
    triangulate, z-gap outliers (K7), plane.

    last_c2f holds the c2f diagnostics of the latest frame,
    dict(coverage=, offband=, fallback=), or None when c2f did not run.
    By default the frame decides on the fallback right after the coarse
    pass (two scalars read on the host).  With defer_c2f_fallback the
    windowed pass always runs, last_c2f keeps the two diagnostics as
    device scalars with fallback=None, and resolve_fallback() decides when
    the caller consumes the frame, re-running a tripped one at full range."""

    def __init__(self, cfg: DenseStereoConfig, defer_c2f_fallback: bool = False):
        self.cfg = cfg
        self.defer_c2f_fallback = defer_c2f_fallback
        self.last_c2f: Optional[dict] = None
        self._full_pipe: Optional["DenseStereoPipeline"] = None

    def disparity(self, base_rect: torch.Tensor, match_rect: torch.Tensor) -> torch.Tensor:
        """Filtered disparity of a rectified pair; sets last_c2f."""
        cfg = self.cfg
        if cfg.dense_scale != 1.0:
            h, w = base_rect.shape
            sh, sw = round(h * cfg.dense_scale), round(w * cfg.dense_scale)
            base_rect = resize(base_rect, (sh, sw), interp="cubic")
            match_rect = resize(match_rect, (sh, sw), interp="cubic")
        with span("dense.census"):
            cb = sgm_kernels.census_transform(base_rect, cfg.census_win, cfg.input_smooth_sigma)
            cm = sgm_kernels.census_transform(match_rect, cfg.census_win, cfg.input_smooth_sigma)
        self.last_c2f = None
        use_c2f = _c2f_active(cfg, base_rect.shape)
        with span("dense.disparity"):
            if use_c2f:
                disp_c = coarse_disparity(
                    base_rect, match_rect, cfg.num_disp, cfg.min_disp, cfg.p1, cfg.p2, cfg.directions,
                    cfg.census_win, cfg.uniqueness_ratio, cfg.c2f_factor,
                )
                wstart, cov, offband = compute_row_windows(
                    disp_c, cfg.c2f_factor, cfg.num_disp, cfg.min_disp, cfg.c2f_window
                )
                if self.defer_c2f_fallback:
                    self.last_c2f = {"coverage": cov, "offband": offband, "fallback": None}
                else:
                    cov_v, offband_v = torch.stack([cov, offband]).tolist()  # the host decision point
                    fallback = c2f_should_fallback(cov_v, offband_v, cfg)
                    self.last_c2f = {"coverage": cov_v, "offband": offband_v, "fallback": fallback}
                    use_c2f = not fallback
            if use_c2f:
                disp = windowed_disparity(cb, cm, wstart, cfg.c2f_window, cfg.p1, cfg.p2, cfg.directions,
                                          cfg.uniqueness_ratio)
            else:
                disp = sgm_disparity_census(cb, cm, cfg.num_disp, cfg.min_disp, cfg.p1, cfg.p2, cfg.directions,
                                            cfg.uniqueness_ratio, cfg.lr_max_diff)
        with span("dense.post"):
            return disparity_postprocess(disp, cfg)

    def device_part(self, base_rect, match_rect, geom_pack, uv=None) -> FrameParts:
        """A frame's device work from its rectified pair up to the plane's
        covariance: nothing in it reads the device on the host."""
        cfg = self.cfg
        disp = self.disparity(base_rect, match_rect)
        with span("dense.post"):
            pts, valid, reasons = triangulate_dense(disp, geom_pack, base_rect, match_rect, cfg)
            keep, _ = outlier_removal(pts, valid, cfg)
        with span("dense.plane"):
            plane = plane_stage_device(pts, valid & keep, cfg, uv)
        return FrameParts(pts, reasons, disp, plane, self.last_c2f)

    def tail(self, parts: FrameParts, n: torch.Tensor) -> DenseFrameResult:
        """The frame's result from its device part and the plane's normal on
        the device (plane_stage_tail), with the point count."""
        plane, ok, valid = plane_stage_tail(parts.points, parts.plane, n, self.cfg)
        return DenseFrameResult(
            points=parts.points, valid=valid, plane=plane, plane_ok=ok,
            disparity=parts.disparity, n_points=valid.sum(), fail_reasons=parts.reasons,
        )

    def finish(self, parts: FrameParts) -> DenseFrameResult:
        """The frame's result from its device part: the plane's normal from
        the host read, then the tail."""
        return self.tail(parts, to_device(plane_normal_read(parts.plane), parts.points.device))

    def __call__(self, base_rect, match_rect, geom_pack, uv=None) -> DenseFrameResult:
        """One frame from its rectified pair; uv optionally injects the
        RANSAC pixel picks.  (The reference's signature also takes the
        unrectified images, which nothing in it reads.)"""
        with span("dense.frame"):
            parts = self.device_part(base_rect, match_rect, geom_pack, uv)
            with span("dense.plane"):
                return self.finish(parts)

    def resolve_fallback(self, res, c2f_info, base_rect, match_rect, geom_pack, uv=None):
        """Consume the deferred c2f diagnostics of one frame: read the two
        scalars and, if the guard trips, re-run the frame at full range.
        Returns (result, resolved c2f dict)."""
        if c2f_info is None or c2f_info.get("fallback") is not None:
            return res, c2f_info
        cov_v, offband_v = float(c2f_info["coverage"]), float(c2f_info["offband"])
        fallback = c2f_should_fallback(cov_v, offband_v, self.cfg)
        if fallback:
            if self._full_pipe is None:
                self._full_pipe = DenseStereoPipeline(dataclasses.replace(self.cfg, c2f_window=0))
            res = self._full_pipe(base_rect, match_rect, geom_pack, uv=uv)
        return res, {"coverage": cov_v, "offband": offband_v, "fallback": fallback}


def dense_stereo_frame(img0, img1, K0, K1, R, T, cfg: DenseStereoConfig = DenseStereoConfig(), device="cpu", uv=None):
    """One frame from the undistorted cam0/cam1 images (numpy): host
    geometry, AUTO smoothing resolved from img0, rectification and the
    dense pipeline on `device` (uv: optional RANSAC pixel picks).
    Returns (DenseFrameResult, FrameGeometry)."""
    H, W = img0.shape
    geom = prepare_frame_geometry(K0, K1, R, T, (W, H), cam_distance=cfg.cam_distance)
    if cfg.input_smooth_sigma < 0:
        from wass_tpu_torch.prepare.degradation import resolve_smooth_sigma

        cfg = dataclasses.replace(cfg, input_smooth_sigma=resolve_smooth_sigma(cfg.input_smooth_sigma, img0, "dense"))
    b_img, m_img = (img0, img1) if geom.base_is_cam0 else (img1, img0)
    b = torch.as_tensor(np.asarray(b_img, np.float32), device=device)
    m = torch.as_tensor(np.asarray(m_img, np.float32), device=device)
    base_rect = rectify_on_device(b, geom.H_base, (H, W))
    match_rect = rectify_on_device(m, geom.H_match, (H, W))
    geom_pack = build_geom_pack(geom, (H, W), device)
    return DenseStereoPipeline(cfg)(base_rect, match_rect, geom_pack, uv=uv), geom
