"""Synthetic sequences for smoke runs and benchmarks of the port.

Scenes come from the port's copy of the JAX package's numpy generator
(testing/synthetic.py): a ray-traced wave field seen by a known rig, with
per-pixel ground truth.  This module renders (or loads a cached) scene,
writes it as frame workdirs the stereo stage reads, reads a frame's
results back through the port's io/workdir.py, and scores them with the
verify_meshes elevation gate; and it renders (or loads cached) raw frames
seen through a known lens distortion and writes them as the prepare
stage's input.
"""

from __future__ import annotations

import hashlib
import shutil
from pathlib import Path

import numpy as np

from wass_tpu_torch.io.workdir import Workdir
from wass_tpu_torch.testing.synthetic import SyntheticRig, SyntheticScene, WaveField, make_scene

_RIG_KEYS = ("K0", "K1", "R0", "T0", "R1", "T1")
_WAVE_KEYS = ("amps", "kx", "ky", "phases")
_IMAGE_KEYS = ("img0", "img1", "depth0", "points0")
WAVE_AMPLITUDE = 0.25  # the benchmark scene of the reference (bench.py)


def load_or_make_scene(width: int, height: int, seed: int, cache_dir) -> SyntheticScene:
    """The scene make_scene(seed, width, height, WAVE_AMPLITUDE) renders,
    cached as .npz in cache_dir (a 3 MP render takes minutes on the host).
    A cached scene carries images, ground-truth points and the rig."""
    cache_dir = Path(cache_dir)
    cache = cache_dir / f"scene_{width}x{height}_{seed}.npz"
    if cache.exists():
        z = np.load(cache)
        rig = SyntheticRig(width=width, height=height, **{k: z[k] for k in _RIG_KEYS})
        waves = WaveField(**{k: z[k] for k in _WAVE_KEYS})
        return SyntheticScene(rig=rig, waves=waves, texture_scale=float(z["texture_scale"]),
                              **{k: z[k] for k in _IMAGE_KEYS})
    sc = make_scene(seed=seed, width=width, height=height, wave_amplitude=WAVE_AMPLITUDE)
    cache_dir.mkdir(parents=True, exist_ok=True)
    tmp = cache.with_suffix(".tmp.npz")
    np.savez(tmp, texture_scale=sc.texture_scale,
             **{k: getattr(sc, k) for k in _IMAGE_KEYS},
             **{k: getattr(sc.rig, k) for k in _RIG_KEYS},
             **{k: getattr(sc.waves, k) for k in _WAVE_KEYS})
    tmp.replace(cache)
    return sc


def write_sequence(seq_dir, img0: np.ndarray, img1: np.ndarray, rig: SyntheticRig, n_frames: int) -> list:
    """n_frames workdirs of the same pair with the rig's intrinsics and
    extrinsics (so the stereo stage needs no match/autocalibrate).  Images
    are written as 8-bit PNG by the port's codec."""
    return write_pairs(seq_dir, [(img0, img1)] * n_frames, rig)


def write_pairs(seq_dir, pairs, rig: SyntheticRig) -> list:
    """One workdir a pair (img0, img1) of `pairs`, as write_sequence."""
    seq_dir = Path(seq_dir)
    if seq_dir.exists():
        shutil.rmtree(seq_dir)
    wds = []
    for i, pair in enumerate(pairs):
        wd = Workdir(seq_dir / f"{i:06d}_wd").create()
        for cam, img in enumerate(pair):
            wd.save_undistorted(cam, img)
        wd.save_intrinsics(0, rig.K0)
        wd.save_intrinsics(1, rig.K1)
        wd.save_extrinsics(rig.R, rig.T)
        wds.append(wd.path)
    return wds


def distort_image(img: np.ndarray, K: np.ndarray, dist) -> np.ndarray:
    """An approximate raw frame of the ideal image `img` through a lens with
    distortion `dist` (OpenCV's model): each raw pixel samples img
    (bilinear, 0 outside) at its undistorted position.  Prepare's
    undistortion takes it back to img up to the two resamplings; for raw
    frames resampled once, as a camera records them, see load_or_render_raw."""
    import torch

    from wass_tpu_torch.ops.sampling import bilinear_sample, undistort_points

    H, W = img.shape
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    vv, uu = torch.meshgrid(torch.arange(H, dtype=torch.float32), torch.arange(W, dtype=torch.float32), indexing="ij")
    src = undistort_points(torch.stack([uu, vv], -1), f32(K), f32(np.reshape(dist, -1)))
    return bilinear_sample(f32(img), src[..., 0], src[..., 1]).numpy()


def load_or_render_raw(rig: SyntheticRig, seed: int, dist0, dist1, cache_dir) -> tuple:
    """The raw frames (img0, img1) of load_or_make_scene(width, height,
    seed)'s surface seen through lenses with distortions dist0 / dist1
    (synthetic.render_raw: each raw pixel traced along its own ray), cached
    as .npz in cache_dir by seed and lenses."""
    from wass_tpu_torch.testing.synthetic import render_raw

    key = hashlib.sha256(np.asarray([dist0, dist1], np.float64).tobytes()).hexdigest()[:12]
    cache = Path(cache_dir) / f"raw_{rig.width}x{rig.height}_{seed}_{key}.npz"
    if cache.exists():
        z = np.load(cache)
        return z["img0"], z["img1"]
    img0, img1 = render_raw(seed, rig, dist0, dist1, wave_amplitude=WAVE_AMPLITUDE)
    cache.parent.mkdir(parents=True, exist_ok=True)
    tmp = cache.with_suffix(".tmp.npz")
    np.savez(tmp, img0=img0, img1=img1)
    tmp.replace(cache)
    return img0, img1


# Raw frame formats of write_raw_sequence and their file suffixes: forms a
# camera's software writes, each of which prepare reads back as the frame
# (JPEG up to its loss).
RAW_FORMATS = {"png": ".png", "colour_png": ".png", "png16": ".png", "jpeg95": ".jpg", "tiff32": ".tiff"}


def encode_raw(img: np.ndarray, fmt: str) -> bytes:
    """An (H, W) uint8 frame in RAW_FORMATS[fmt]: 8-bit grey PNG (the port's
    codec), colour PNG with R = G = B, 16-bit PNG of frame x 257 (its high
    byte the frame), quality-95 JPEG, float32 TIFF."""
    import cv2

    from wass_tpu_torch.io import png

    if fmt == "png":
        return png.encode_gray(img)
    arr, params = {
        "colour_png": (np.stack([img] * 3, axis=-1), ()),
        "png16": (img.astype(np.uint16) * 257, ()),
        "jpeg95": (img, (cv2.IMWRITE_JPEG_QUALITY, 95)),
        "tiff32": (img.astype(np.float32), ()),
    }[fmt]
    ok, buf = cv2.imencode(RAW_FORMATS[fmt], arr, list(params))
    if not ok:
        raise ValueError(f"OpenCV cannot encode {fmt}")
    return buf.tobytes()


def png_with_filters(img: np.ndarray, ftypes) -> bytes:
    """PNG bytes of an (H, W) uint8 image whose row y is filtered with
    ftypes[y] (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth; libpng writers
    choose among them row by row)."""
    import struct
    import zlib

    from wass_tpu_torch.io import png

    x = img.astype(np.int32)
    a = np.pad(x, ((0, 0), (1, 0)))[:, :-1]
    b = np.pad(x, ((1, 0), (0, 0)))[:-1]
    c = np.pad(x, ((1, 0), (1, 0)))[:-1, :-1]
    ftypes = np.broadcast_to(np.asarray(ftypes, np.uint8), x.shape[:1])
    pred = np.choose(np.broadcast_to(ftypes[:, None], x.shape), [np.zeros_like(x), a, b, (a + b) >> 1, png._paeth(a, b, c)])
    raw = np.empty((x.shape[0], x.shape[1] + 1), np.uint8)
    raw[:, 0] = ftypes
    raw[:, 1:] = (x - pred) & 0xFF
    ihdr = struct.pack(">IIBBBBB", x.shape[1], x.shape[0], 8, 0, 0, 0, 0)
    return (png._SIGNATURE + png._chunk(b"IHDR", ihdr) + png._chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + png._chunk(b"IEND", b""))


def write_raw_sequence(root, raw0: np.ndarray, raw1: np.ndarray, rig: SyntheticRig, n_frames: int,
                       dist0=None, dist1=None, fmt: str = "png") -> tuple:
    """The input of the prepare stage: n_frames copies of the raw pair
    (raw0, raw1) as frames of RAW_FORMATS[fmt] (8-bit grey PNG by default)
    in root/cam0 and root/cam1, and root/calib with intrinsics_0{0,1}.xml,
    ext_R.xml, ext_T.xml and, for each lens given,
    distortion_0{0,1}.xml.  Returns (cam0, cam1, calib)."""
    from wass_tpu_torch.io.matrices import save_matrix_xml

    root = Path(root)
    dirs = tuple(root / d for d in ("cam0", "cam1", "calib"))
    for d in dirs:
        if d.exists():
            shutil.rmtree(d)
        d.mkdir(parents=True)
    for cam, (img, K, dist) in enumerate(((raw0, rig.K0, dist0), (raw1, rig.K1, dist1))):
        if dist is not None:
            save_matrix_xml(dirs[2] / f"distortion_0{cam}.xml", "distortion", np.reshape(dist, (1, -1)))
        save_matrix_xml(dirs[2] / f"intrinsics_0{cam}.xml", "intrinsics", K)
        data = encode_raw(np.clip(np.asarray(img), 0, 255).astype(np.uint8), fmt)
        for i in range(n_frames):
            (dirs[cam] / f"{i:06d}{RAW_FORMATS[fmt]}").write_bytes(data)
    save_matrix_xml(dirs[2] / "ext_R.xml", "ext_R", rig.R)
    save_matrix_xml(dirs[2] / "ext_T.xml", "ext_T", np.reshape(rig.T, (3, 1)))
    return dirs


def read_frame(wd_path):
    """(plane (4,), mesh (N, 3) cam0 points, kernel launches dict) of one
    reconstructed frame workdir."""
    wd = Workdir(Path(wd_path))
    launches = {}
    for line in (wd.path / "wass_stereo_log.txt").read_text().splitlines():
        if "kernel launches:" in line:
            launches = {k: int(v) for k, v in (kv.split("=") for kv in line.split("kernel launches:")[1].split())}
    return wd.load_plane(), wd.load_mesh_cam().T, launches


def trimmed_elevation_error(scene: SyntheticScene, mesh: np.ndarray, plane: np.ndarray) -> float:
    """verify_meshes-style error in baseline units: mean of the smallest
    99.9% of the plane-aligned |z_rec - z_gt| (reference gate: < 0.02)."""
    err = scene.elevation_error(np.asarray(mesh, np.float64), np.asarray(plane, np.float64))
    ae = np.sort(err[np.isfinite(err)])
    return float(ae[: int(len(ae) * 0.999)].mean())
