"""PLY point-cloud / triangulated-mesh export.

The port's copy of wass_tpu/io/ply.py (numpy on the host, the same bytes):
PovMesh::save_as_ply_points (PovMesh.cpp:463-517, binary little-endian
xyz+rgb) and save_as_triangulated_ply (:1077-1221, grid triangles gated by
a z-gap threshold), plus save_as_xyz_ascii/binary.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np


def save_ply_points(path, pts: np.ndarray, colors: Optional[np.ndarray] = None) -> None:
    """Binary little-endian PLY: float x,y,z + uchar r,g,b."""
    pts = np.asarray(pts, np.float32).reshape(-1, 3)
    n = len(pts)
    if colors is None:
        colors = np.full((n, 3), 200, np.uint8)
    colors = np.asarray(colors, np.uint8).reshape(-1, 3)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    rec = np.zeros(n, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
    rec["xyz"] = pts
    rec["rgb"] = colors
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(rec.tobytes())


def save_triangulated_ply(
    path,
    points_grid: np.ndarray,
    valid: np.ndarray,
    max_z_gap: float,
    colors: Optional[np.ndarray] = None,
) -> None:
    """Grid-organized cloud -> triangle mesh; a grid cell produces its two
    triangles only when all three vertices are valid and their pairwise
    |dz| stays below max_z_gap (PovMesh.cpp:1077-1221)."""
    H, W, _ = points_grid.shape
    valid = np.asarray(valid, bool)
    idx = -np.ones((H, W), np.int64)
    idx[valid] = np.arange(valid.sum())
    pts = points_grid[valid]
    z = points_grid[..., 2]

    def tri_ok(a, b, c):
        va = valid[a]
        vb = valid[b]
        vc = valid[c]
        ok = va & vb & vc
        za, zb, zc = z[a], z[b], z[c]
        gap = np.maximum(np.abs(za - zb), np.maximum(np.abs(zb - zc), np.abs(za - zc)))
        return ok & (gap < max_z_gap)

    sl00 = (slice(0, H - 1), slice(0, W - 1))
    sl01 = (slice(0, H - 1), slice(1, W))
    sl10 = (slice(1, H), slice(0, W - 1))
    sl11 = (slice(1, H), slice(1, W))
    tris = []
    ok1 = tri_ok(sl00, sl10, sl01)
    tris.append(np.stack([idx[sl00][ok1], idx[sl10][ok1], idx[sl01][ok1]], axis=1))
    ok2 = tri_ok(sl01, sl10, sl11)
    tris.append(np.stack([idx[sl01][ok2], idx[sl10][ok2], idx[sl11][ok2]], axis=1))
    faces = np.concatenate(tris) if tris else np.zeros((0, 3), np.int64)

    if colors is None:
        cols = np.full((len(pts), 3), 200, np.uint8)
    else:
        cols = np.asarray(colors, np.uint8)[valid.reshape(-1)] if colors.ndim > 2 else colors

    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(pts)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        f"element face {len(faces)}\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
    )
    vrec = np.zeros(len(pts), dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
    vrec["xyz"] = pts.astype(np.float32)
    vrec["rgb"] = cols[: len(pts)]
    frec = np.zeros(len(faces), dtype=[("n", "u1"), ("idx", "<i4", 3)])
    frec["n"] = 3
    frec["idx"] = faces.astype(np.int32)
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(vrec.tobytes())
        f.write(frec.tobytes())


def save_xyz_ascii(path, pts: np.ndarray, stride: int = 1) -> None:
    pts = np.asarray(pts).reshape(-1, 3)[::stride]
    with open(path, "w") as f:
        for p in pts:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")


def save_xyz_binary(path, pts: np.ndarray) -> None:
    """save_as_xyz_binary contract: u32 count + 3*f64 per point."""
    pts = np.asarray(pts, np.float64).reshape(-1, 3)
    with open(path, "wb") as f:
        f.write(struct.pack("<I", len(pts)))
        f.write(pts.astype("<f8").tobytes())


def load_xyz_binary(path) -> np.ndarray:
    with open(path, "rb") as f:
        n = struct.unpack("<I", f.read(4))[0]
        return np.frombuffer(f.read(n * 24), "<f8").reshape(n, 3)
