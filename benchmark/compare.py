"""The comparison that decides `correct`: the files the window's writers
wrote for a frame against the plain reference's outputs for the same pair.

Each number is the worst over the compared frames:

  plane_gap     the widest gap between a coefficient of plane.txt and the
                reference's plane (unit normal and offset, baseline units);
                a plane on one side only counts as a gap of 1e30.
  mesh_gap      the widest distance (max-norm, baseline units) between a
                decoded mesh_cam.xyzC point and the reference's point of
                the same base pixel.  Rows are matched to pixels by
                projecting each decoded point through the reference's
                rectification and taking the nearest reference point among
                the 3x3 pixels around it (the u16 quantization moves a
                point by well under a pixel).
  rows_off      the share of rows, relative to the reference's count, that
                only one side has (rows with no reference pixel in reach,
                reference pixels no row lands on).
  render_gap    the widest difference, in grey levels, between a decoded
                debug render and the reference's render after the same JPEG
                encoding; a missing or misshapen image counts as 256.
  frames_missing  window frames whose plane.txt or mesh_cam.xyzC (and, with
                renders, any of the six JPEGs) was not written (all frames).
"""

from __future__ import annotations

from pathlib import Path

import cv2
import numpy as np
import torch

from reference.pipeline import mesh_cam0
from reference.xyzc import load_camera_mesh

MISSING = 1e30  # the gap of a plane that one side lacks
RENDER_NAMES = ("stereo_input.jpg", "disparity_final_scaled.jpg", "stereo.jpg", "disparity_coverage.jpg",
                "graph_components.jpg", "triangulation_failmap.jpg")


def read_mesh(path) -> np.ndarray:
    """A .xyzC file decoded to camera-0 points (N, 3), float64."""
    return load_camera_mesh(path).T


def read_plane(path) -> np.ndarray:
    vals = np.loadtxt(path).reshape(-1)[:4]
    return vals.astype(np.float64)


def plane_gap(p: np.ndarray, r: np.ndarray) -> float:
    fp, fr = bool(np.all(np.isfinite(p))), bool(np.all(np.isfinite(r)))
    if fp != fr:
        return MISSING
    return float(np.max(np.abs(p - r))) if fp else 0.0


def base_pixels(pts: torch.Tensor, geom) -> torch.Tensor:
    """Camera-0 points (N, 3) float64 -> (N, 2) float rectified base-image
    coordinates, through the reference's geometry."""
    dev = pts.device
    f64 = dict(dtype=torch.float64, device=dev)
    if geom.base_is_cam0:
        Xb, K = pts, torch.as_tensor(geom.K0, **f64)
    else:
        R, T = torch.as_tensor(geom.R, **f64), torch.as_tensor(geom.T, **f64)
        Xb, K = pts @ R.T + T, torch.as_tensor(geom.K1, **f64)
    uv = Xb @ K.T
    uv = uv[:, :2] / uv[:, 2:3]
    Hm = torch.as_tensor(geom.H_base, **f64)
    h = torch.cat([uv, torch.ones_like(uv[:, :1])], 1) @ Hm.T
    return h[:, :2] / h[:, 2:3]


@torch.no_grad()
def mesh_gaps(prog_pts: np.ndarray, ref: dict, device) -> tuple:
    """(mesh_gap, rows_off) of a program mesh (N, 3) camera-0 points against
    a reference frame (pipeline.frame's output)."""
    n_ref = 0 if ref["rows"] is None else len(ref["rows"])
    n_prog = len(prog_pts)
    if n_ref == 0 or n_prog == 0:
        return (0.0, 0.0) if n_ref == n_prog else (MISSING, 1.0)
    valid = ref["res"].valid
    H, W = valid.shape
    f64 = dict(dtype=torch.float64, device=device)
    ref_pts = torch.as_tensor(mesh_cam0(ref), **f64)
    lookup = torch.full((H * W,), -1, dtype=torch.int64, device=device)
    idx = torch.nonzero(valid.reshape(-1).to(device)).reshape(-1)
    lookup[idx] = torch.arange(len(idx), device=device)
    P = torch.as_tensor(prog_pts, **f64)
    xy = torch.round(base_pixels(P, ref["geom"]))
    best = torch.full((n_prog,), float("inf"), **f64)
    best_row = torch.full((n_prog,), -1, dtype=torch.int64, device=device)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            x, y = xy[:, 0] + dx, xy[:, 1] + dy
            inside = torch.isfinite(x) & torch.isfinite(y) & (x >= 0) & (x < W) & (y >= 0) & (y < H)
            pix = torch.where(inside, y * W + x, 0).to(torch.int64)
            row = torch.where(inside, lookup[pix], -1)
            d = (P - ref_pts[row.clamp_min(0)]).abs().amax(1)
            d = torch.where(row >= 0, d, float("inf"))
            take = d < best
            best = torch.where(take, d, best)
            best_row = torch.where(take, row, best_row)
    matched = best_row >= 0
    hit = torch.unique(best_row[matched])
    off = (n_prog - len(hit)) + (n_ref - len(hit))
    gap = float(best[matched].max()) if bool(matched.any()) else MISSING
    return gap, off / n_ref


def render_gap(wd: Path, ref_images: dict) -> float:
    worst = 0.0
    for name in RENDER_NAMES:
        path = wd / name
        img = cv2.imdecode(np.fromfile(path, np.uint8), cv2.IMREAD_UNCHANGED) if path.exists() else None
        want = ref_images.get(name)
        if img is None or want is None or img.shape != want.shape:
            return 256.0
        worst = max(worst, float(np.abs(img.astype(np.int16) - want.astype(np.int16)).max()))
    return worst


def frame_written(wd: Path, renders: bool) -> bool:
    names = ["plane.txt", "mesh_cam.xyzC"] + (list(RENDER_NAMES) if renders else [])
    return all((wd / n).exists() for n in names)


def compare_frame(wd: Path, ref: dict, device, ref_images=None) -> dict:
    """The numbers of one written frame against its reference."""
    out = {"plane_gap": plane_gap(read_plane(wd / "plane.txt"), ref["plane"])}
    mesh = read_mesh(wd / "mesh_cam.xyzC")
    # Without a reference plane the reference writes no u16 rows; whether
    # the program agrees that the frame has no plane is plane_gap's to say.
    if np.all(np.isfinite(ref["plane"])):
        out["mesh_gap"], out["rows_off"] = mesh_gaps(mesh, ref, device)
    else:
        out["mesh_gap"], out["rows_off"] = 0.0, 0.0
    if ref_images is not None:
        out["render_gap"] = render_gap(wd, ref_images)
    return out


def worst(readings: list) -> dict:
    """The worst reading of each number over the compared frames."""
    keys = sorted({k for r in readings for k in r})
    return {k: max(r[k] for r in readings if k in r) for k in keys}


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, checks): each compared number with its limit; a number
    passes when it is at most its limit (exact numbers have the limit 0)."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits if k in numbers}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
