"""Reference copy of wass_tpu_torch/io/xyzc.py (the decoder and the quantized
writer) and of io/workdir.py's plane.txt writer, frozen when the
benchmark was written: plain PyTorch and NumPy, importing nothing of the
program; where the program launches a CUDA kernel this copy runs the
kernel's plain version.  The original's notes follow.

The .xyzC compressed point-cloud format — the pipeline's durable artifact.

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

import numpy as np


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


def save_xyz_quantized(path, quant: np.ndarray, scales, mins, Rinv: np.ndarray, Tinv: np.ndarray) -> None:
    """Write pre-quantized u16 plane-frame points (N, 3)."""
    q = np.ascontiguousarray(np.asarray(quant, dtype="<u2"))
    with open(path, "wb") as f:
        f.write(struct.pack("<I", int(q.shape[0])))
        f.write(struct.pack("<3d", *np.asarray(scales, np.float64)))
        f.write(struct.pack("<3d", *np.asarray(mins, np.float64)))
        f.write(np.asarray(Rinv, dtype=np.float64).reshape(9).tobytes())
        f.write(np.asarray(Tinv, dtype=np.float64).reshape(3).tobytes())
        f.write(q.tobytes())


def save_plane(path, plane) -> None:
    """plane.txt: 4 coefficients, one per line, 20 digits; 'nan nan nan
    nan' when there is no plane."""
    with open(path, "w") as f:
        if plane is None or not np.all(np.isfinite(plane)):
            f.write("nan nan nan nan\n")
        else:
            for c in np.asarray(plane).reshape(4):
                f.write(f"{c:.20g}\n")
