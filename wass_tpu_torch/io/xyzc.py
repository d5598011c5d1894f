"""The .xyzC compressed point-cloud format — the pipeline's durable artifact.

Byte-exact implementation of PovMesh::save_as_xyz_compressed
(src/wass_stereo/PovMesh.cpp:377-460) and the reference
Python decoder load_camera_mesh
(gridding/wassgridsurface/wass_utils.py:22-35):

  u32    npts
  f64x3  xscale, yscale, zscale        (65535 / range)
  f64x3  minx, miny, minz
  f64x9  Rinv (row-major)              plane-frame -> camera-frame rotation
  f64x3  Tinv
  u16x3N points, Fortran order per the decoder: data[3, N] column-major,
         i.e. x0 y0 z0 x1 y1 z1 ... quantized as (p - min) * scale

Points are stored in the *sea-plane frame* (p_plane = R p_cam + T with
(R, T) from the fitted plane); Rinv/Tinv restore camera coordinates.

The port's own copy of the JAX package's wass_tpu/io/xyzc.py, with the same
behaviour (the port imports nothing of the JAX package); file
references are to the WASS reference sources.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


def save_xyz_compressed(path, pts_plane: np.ndarray, Rinv: np.ndarray, Tinv: np.ndarray) -> None:
    """Write plane-frame points (N, 3) plus the inverse plane transform."""
    pts = np.asarray(pts_plane, dtype=np.float64)
    n = np.uint32(pts.shape[0])
    if pts.shape[0] == 0:
        mins = np.zeros(3)
        scales = np.ones(3)
    else:
        mins = pts.min(axis=0)
        maxs = pts.max(axis=0)
        rng = np.where(maxs - mins > 0, maxs - mins, 1.0)
        scales = 65535.0 / rng
    quant = ((pts - mins) * scales).astype(np.uint16)  # C-truncation like the ref's static_cast
    with open(path, "wb") as f:
        f.write(struct.pack("<I", int(n)))
        f.write(struct.pack("<3d", *scales))
        f.write(struct.pack("<3d", *mins))
        f.write(np.asarray(Rinv, dtype=np.float64).reshape(9).tobytes())
        f.write(np.asarray(Tinv, dtype=np.float64).reshape(3).tobytes())
        # Interleaved x,y,z per point == data[3, N] in Fortran order.
        f.write(quant.astype("<u2").tobytes())


def save_xyz_quantized(path, quant: np.ndarray, scales, mins, Rinv: np.ndarray, Tinv: np.ndarray) -> None:
    """Write pre-quantized u16 plane-frame points (N, 3) — the device-side
    export path (stereo/dense._stage_export) quantizes on device so the
    host only streams the wire payload."""
    q = np.ascontiguousarray(np.asarray(quant, dtype="<u2"))
    with open(path, "wb") as f:
        f.write(struct.pack("<I", int(q.shape[0])))
        f.write(struct.pack("<3d", *np.asarray(scales, np.float64)))
        f.write(struct.pack("<3d", *np.asarray(mins, np.float64)))
        f.write(np.asarray(Rinv, dtype=np.float64).reshape(9).tobytes())
        f.write(np.asarray(Tinv, dtype=np.float64).reshape(3).tobytes())
        f.write(q.tobytes())


def load_camera_mesh(path) -> np.ndarray:
    """Decode to camera-frame points (3, N), mirroring wass_utils.py:22-35."""
    with open(path, "rb") as f:
        npts = struct.unpack("<I", f.read(4))[0]
        limits = np.array(struct.unpack("<6d", f.read(48)))
        Rinv = np.frombuffer(f.read(72), dtype="<f8").reshape(3, 3)
        Tinv = np.frombuffer(f.read(24), dtype="<f8").reshape(3, 1)
        data = np.frombuffer(f.read(npts * 6), dtype="<u2").reshape(npts, 3).T
    mesh = data.astype(np.float64)
    mesh = mesh / limits[0:3, None] + limits[3:6, None]
    return Rinv @ mesh + Tinv


def load_plane_frame_mesh(path):
    """Decode to (pts_plane (N,3), Rinv, Tinv) without applying the inverse
    transform — useful for gridding, which works in the sea-plane frame."""
    with open(path, "rb") as f:
        npts = struct.unpack("<I", f.read(4))[0]
        limits = np.array(struct.unpack("<6d", f.read(48)))
        Rinv = np.frombuffer(f.read(72), dtype="<f8").reshape(3, 3).copy()
        Tinv = np.frombuffer(f.read(24), dtype="<f8").reshape(3).copy()
        data = np.frombuffer(f.read(npts * 6), dtype="<u2").reshape(npts, 3)
    pts = data.astype(np.float64) / limits[0:3][None, :] + limits[3:6][None, :]
    return pts, Rinv, Tinv
