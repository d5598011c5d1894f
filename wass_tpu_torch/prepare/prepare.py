"""The image-preparation stage (wass_prepare equivalent).

Counterpart of wass_tpu/prepare/prepare.py.  Per frame: raw images and
per-camera intrinsics/distortion in, optional polarimetric demosaic path,
optional CLAHE, undistortion, and the workdir contract out
(undistorted/0000000{0,1}.png, the per-frame intrinsics XMLs, extrinsics
passed through), as main() of wass_prepare.cpp:303-540 of the WASS
sources.  The image work runs on `device`; file IO stays on the host.
With demosaic and save_stokes the Stokes images go next to the PNGs as
float32 TIFFs, undistorted/0000000{cam}_S{0,1,2}.tiff (io/image.py), as
the JAX package writes them through imageio.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from wass_tpu_torch.device import resolve_device, to_device
from wass_tpu_torch.io.image import write_float_tiff
from wass_tpu_torch.io.workdir import Workdir
from wass_tpu_torch.ops.sampling import undistort_image
from wass_tpu_torch.prepare.clahe import clahe
from wass_tpu_torch.prepare.polar import polarimetric_process


@dataclasses.dataclass(frozen=True)
class PrepareConfig:
    """Defaults mirror wass_prepare's incfg options (:36-39) and CLI flags."""

    clahe_clip_limit_cam0: float = 2.0
    clahe_tile_px_cam0: int = 0  # 0 disables (CAM0_CLAHE_TILEGRIDSIZE)
    clahe_clip_limit_cam1: float = 2.0
    clahe_tile_px_cam1: int = 0
    demosaic: bool = False
    hdr: bool = False
    save_stokes: bool = False  # write _S0/_S1/_S2.tiff next to the PNGs


def _clahe_tiles(shape, tile_px: int):
    """(tiles_y, tiles_x) for a tile size in pixels; (0, 0) when disabled."""
    H, W = shape
    return (max(H // tile_px, 1), max(W // tile_px, 1)) if tile_px > 0 else (0, 0)


def prepare_image(img: np.ndarray, K: np.ndarray, dist: np.ndarray, cfg: PrepareConfig, cam: int,
                  device="cuda", out_stokes_prefix=None) -> np.ndarray:
    """One raw frame -> its undistorted image, float in [0, 255]; with
    demosaic, save_stokes and a prefix, also its Stokes TIFFs."""
    tile_px = cfg.clahe_tile_px_cam0 if cam == 0 else cfg.clahe_tile_px_cam1
    clip = cfg.clahe_clip_limit_cam0 if cam == 0 else cfg.clahe_clip_limit_cam1
    dist = np.asarray(dist).reshape(-1)
    tiles = _clahe_tiles(np.shape(img), tile_px)
    if not cfg.demosaic and tiles == (0, 0) and not np.any(dist):
        # Zero distortion and no CLAHE: cv::undistort is the identity
        # (wass_prepare.cpp:268), so no device work at all.
        return np.clip(np.asarray(img, np.float64), 0, 255)
    device = resolve_device(device)
    x = to_device(torch.as_tensor(np.asarray(img, np.float32)), device)
    Kt = to_device(torch.as_tensor(np.asarray(K, np.float32)), device)
    dt = to_device(torch.as_tensor(dist.astype(np.float32)), device)
    if cfg.demosaic:
        res = polarimetric_process(x, Kt, dt, use_hdr=cfg.hdr)
        if cfg.save_stokes and out_stokes_prefix is not None:
            for name, arr in (("S0", res.S0), ("S1", res.S1), ("S2", res.S2)):
                write_float_tiff(f"{out_stokes_prefix}_{name}.tiff", arr.cpu().numpy())
        out = res.intensity
        if tiles != (0, 0):
            out = clahe(out, clip, tiles_x=tiles[1], tiles_y=tiles[0])
    else:
        if tiles != (0, 0):
            x = clahe(x, clip, tiles_x=tiles[1], tiles_y=tiles[0])
        out = undistort_image(x, Kt, dt)
    return np.clip(out.cpu().numpy(), 0, 255)


def prepare_frame(
    workdir_path,
    img0: np.ndarray,
    img1: np.ndarray,
    K0: np.ndarray,
    d0: np.ndarray,
    K1: np.ndarray,
    d1: np.ndarray,
    cfg: PrepareConfig = PrepareConfig(),
    ext_R: Optional[np.ndarray] = None,
    ext_T: Optional[np.ndarray] = None,
    device="cuda",
) -> Workdir:
    """Create and populate one frame workdir (the wass_prepare contract)."""
    wd = Workdir(workdir_path).create()
    pref0 = wd.path / "undistorted" / "00000000" if cfg.save_stokes else None
    pref1 = wd.path / "undistorted" / "00000001" if cfg.save_stokes else None
    u0 = prepare_image(img0, K0, d0, cfg, cam=0, device=device, out_stokes_prefix=pref0)
    u1 = prepare_image(img1, K1, d1, cfg, cam=1, device=device, out_stokes_prefix=pref1)
    wd.save_undistorted(0, u0)
    wd.save_undistorted(1, u1)
    wd.save_intrinsics(0, K0)
    wd.save_intrinsics(1, K1)
    # Extrinsics passthrough (wass_prepare.cpp:504-523): a known
    # calibration lets the pipeline skip match/autocalibrate.
    if ext_R is not None and ext_T is not None:
        wd.save_extrinsics(ext_R, ext_T)
    return wd
