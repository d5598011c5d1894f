"""Synthetic sequences for smoke runs and benchmarks of the port.

Scenes come from the JAX package's numpy generator (wass_tpu.testing): a
ray-traced wave field seen by a known rig, with per-pixel ground truth.
This module renders (or loads a cached) scene, writes it as frame
workdirs the stereo stage reads, reads a frame's results back through
wass_tpu.io, and scores them with the verify_meshes elevation gate.
"""

from __future__ import annotations

import shutil
from pathlib import Path

import numpy as np

from wass_tpu.io.workdir import Workdir
from wass_tpu.testing.synthetic import SyntheticRig, SyntheticScene, WaveField, make_scene
from wass_tpu_torch.io.png import write_gray

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
    seq_dir = Path(seq_dir)
    if seq_dir.exists():
        shutil.rmtree(seq_dir)
    wds = []
    for i in range(n_frames):
        wd = Workdir(seq_dir / f"{i:06d}_wd").create()
        for cam, img in enumerate((img0, img1)):
            write_gray(wd.undistorted_path(cam), np.clip(np.asarray(img), 0, 255).astype(np.uint8))
        wd.save_intrinsics(0, rig.K0)
        wd.save_intrinsics(1, rig.K1)
        wd.save_extrinsics(rig.R, rig.T)
        wds.append(wd.path)
    return wds


def read_frame(wd_path):
    """(plane (4,), mesh (N, 3) cam0 points, kernel launches dict) of one
    reconstructed frame workdir, read through wass_tpu.io."""
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
