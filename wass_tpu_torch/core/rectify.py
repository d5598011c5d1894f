"""Stereo rectification homographies (host, float64 numpy).

Copied from wass_tpu/core/rectify.py (the WASS custom method,
stereorectify.cpp:57-244): that package's __init__ imports jax, and the
port imports no jax.  Only the route the dense path uses is copied.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np


class RectifyResult(NamedTuple):
    HL: np.ndarray  # (3,3) homography: left image -> rectified left
    HR: np.ndarray  # (3,3) homography: right image -> rectified right
    roi: Tuple[int, int, int, int]  # (x, y, w, h) common ROI in rectified frame
    angle_deg: float


def _rect_plane_rotation(ep1: np.ndarray) -> np.ndarray:
    """Rotation with rows (baseline, baseline x n, n), n = baseline x e_y."""
    Rv = ep1 / np.linalg.norm(ep1)
    N = np.cross(Rv, np.array([0.0, 1.0, 0.0]))
    N = N / np.linalg.norm(N)
    Rk = np.cross(Rv, N)
    return np.stack([Rv, Rk, N])


def _homographies_for_angle(
    angle_deg: float, Rplane: np.ndarray, K0i: np.ndarray, K1i: np.ndarray, Ri: np.ndarray
):
    """The reference's HFunctional::calc (stereorectify.cpp:91-111)."""
    # Rodrigues of (angle, 0, 0): rotation by angle (in the ref's deg/180*3.14
    # pseudo-radians) around the x-axis of the rectified frame.
    a = angle_deg / 180.0 * 3.14
    ca, sa = np.cos(a), np.sin(a)
    Radd = np.array([[1, 0, 0], [0, ca, -sa], [0, sa, ca]])
    H0 = Radd @ Rplane @ K0i
    H1 = Radd @ Rplane @ Ri @ K1i
    H0 = H0 / H0[2, 2]
    H1 = H1 / H1[2, 2]
    v = max(H0[2, 0] ** 2 + H0[2, 1] ** 2, H1[2, 0] ** 2 + H1[2, 1] ** 2)
    H0 = H0 / np.cbrt(np.linalg.det(H0))
    H1 = H1 / np.cbrt(np.linalg.det(H1))
    return v, H0, H1


def _optimize_angle(Rplane, K0i, K1i, Ri) -> float:
    """Deterministic 1-D minimization of the projective-distortion functional:
    coarse grid over +-60 deg then golden-section refinement."""
    grid = np.linspace(-60.0, 60.0, 481)
    vals = [
        _homographies_for_angle(a, Rplane, K0i, K1i, Ri)[0] for a in grid
    ]
    i = int(np.argmin(vals))
    lo = grid[max(i - 1, 0)]
    hi = grid[min(i + 1, len(grid) - 1)]
    gr = (np.sqrt(5.0) - 1) / 2
    c = hi - gr * (hi - lo)
    d = lo + gr * (hi - lo)
    fc = _homographies_for_angle(c, Rplane, K0i, K1i, Ri)[0]
    fd = _homographies_for_angle(d, Rplane, K0i, K1i, Ri)[0]
    for _ in range(60):
        if fc < fd:
            hi, d, fd = d, c, fc
            c = hi - gr * (hi - lo)
            fc = _homographies_for_angle(c, Rplane, K0i, K1i, Ri)[0]
        else:
            lo, c, fc = c, d, fd
            d = lo + gr * (hi - lo)
            fd = _homographies_for_angle(d, Rplane, K0i, K1i, Ri)[0]
    return float(0.5 * (lo + hi))


def _corners(w: int, h: int) -> np.ndarray:
    return np.array([[0, 0, 1], [w, 0, 1], [w, h, 1], [0, h, 1]], dtype=np.float64).T


def _project(H: np.ndarray, pts: np.ndarray) -> np.ndarray:
    q = H @ pts
    return q[:2] / q[2]


def stereo_rectify_homographies(
    K0: np.ndarray,
    K1: np.ndarray,
    Rinv: np.ndarray,
    Tinv: np.ndarray,
    image_size: Tuple[int, int],
    out_size: Optional[Tuple[int, int]] = None,
    angle_deg: float = 0.0,
) -> RectifyResult:
    """WASS custom rectification (stereorectify.cpp:57-244).

    Args:
      K0, K1: intrinsics of left/right cameras.
      Rinv, Tinv: inverse extrinsics (x_left = Rinv x_right + Tinv); Tinv is
        the right-camera center in the left frame, i.e. the epipole direction.
      image_size: (width, height) of the input images.
      out_size: (width, height) of the rectified output (default: input size).
      angle_deg: extra baseline rotation; 0 triggers the optimization.
    """
    w, h = image_size
    ow, oh = out_size if out_size is not None else image_size
    K0i = np.linalg.inv(np.asarray(K0, dtype=np.float64))
    K1i = np.linalg.inv(np.asarray(K1, dtype=np.float64))
    Ri = np.asarray(Rinv, dtype=np.float64)
    ep1 = np.asarray(Tinv, dtype=np.float64).reshape(3)

    Rplane = _rect_plane_rotation(ep1)
    best_angle = angle_deg
    if angle_deg == 0.0:
        best_angle = _optimize_angle(Rplane, K0i, K1i, Ri)
    _, H0, H1 = _homographies_for_angle(best_angle, Rplane, K0i, K1i, Ri)

    pts0 = _corners(w, h)
    pts1 = _corners(w, h)
    q0 = _project(H0, pts0)
    q1 = _project(H1, pts1)

    # Axis-aligned bounds per image (stereorectify.cpp:178-190: x-bounds from
    # left/right corner pairs, y from top/bottom pairs).
    rect0 = (
        min(q0[0, 0], q0[0, 3]), min(q0[1, 0], q0[1, 1]),
        max(q0[0, 1], q0[0, 2]), max(q0[1, 2], q0[1, 3]),
    )
    rect1 = (
        min(q1[0, 0], q1[0, 3]), min(q1[1, 0], q1[1, 1]),
        max(q1[0, 1], q1[0, 2]), max(q1[1, 2], q1[1, 3]),
    )
    top = min(rect0[1], rect1[1])
    bottom = max(rect0[3], rect1[3])

    def scale_translate(rect):
        Tr = np.array([[1, 0, -rect[0]], [0, 1, -top], [0, 0, 1]], dtype=np.float64)
        Sc = np.array(
            [[ow / (rect[2] - rect[0]), 0, 0], [0, oh / (bottom - top), 0], [0, 0, 1]],
            dtype=np.float64,
        )
        return Sc @ Tr

    H0 = scale_translate(rect0) @ H0
    H1 = scale_translate(rect1) @ H1
    H0 = H0 / np.cbrt(np.linalg.det(H0))
    H1 = H1 / np.cbrt(np.linalg.det(H1))

    # Shared ROI: 4th/5th order statistics of the 8 warped corner coords
    # (stereorectify.cpp:216-243) — a close approximation of the maximal
    # common rectangle.
    q0 = _project(H0, pts0)
    q1 = _project(H1, pts1)
    xs = np.sort(np.concatenate([q0[0], q1[0]]))
    ys = np.sort(np.concatenate([q0[1], q1[1]]))
    roi = (int(xs[3]), int(ys[3]), int(xs[4] - int(xs[3])), int(ys[4] - int(ys[3])))
    return RectifyResult(H0, H1, roi, best_angle)
