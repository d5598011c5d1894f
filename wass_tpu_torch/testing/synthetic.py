"""Synthetic wave-field stereo scenes with exact ground truth.

The reference's golden-test strategy renders synthetic scenes from known
geometry and asserts recovery (WASS_TEST synthetic sequence,
doc/src/render/documentation/testing.html.md:14-110, and the
random-camera self-test in
src/wass_stereo/stereorectify.cpp:247-364).  This module is
our generator: a procedural directional-wave height field textured with
multi-octave value noise, ray-traced from two pinhole cameras with known
K / R / T, returning images plus exact per-pixel ground truth.

World frame: sea mean plane is z_w = 0, +z up.  Cameras sit at height
`cam_height` looking down at `look_down_deg` below the horizon, separated
by a unit-norm-ish baseline — mirroring the reference design point (5 MP,
~10 m elevation, ~20 deg depression, stereo.html.md:13-16).  All outputs are
expressed in the camera-0 frame like the WASS pipeline (extrinsics R, T with
x_cam1 = R x_cam0 + T).

The port's own copy of the JAX package's wass_tpu/testing/synthetic.py, with the same
behaviour (the port imports nothing of the JAX package); file
references are to the WASS reference sources.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


# --------------------------------------------------------------------------
# Procedural fields
# --------------------------------------------------------------------------


def _noise_grids(rng: np.random.Generator, n_octaves: int, base: int) -> list:
    """The value noise's (resolution, lattice, amplitude) per octave."""
    grids = []
    for o in range(n_octaves):
        res = base * (2**o)
        grids.append((res, rng.random((res + 2, res + 2)), 0.55**o))
    return grids


def _value_noise(rng: np.random.Generator, n_octaves: int = 5, base: int = 8):
    """Multi-octave value noise on [0,1]^2 -> callable(x, y) in [0, 1]."""
    grids = _noise_grids(rng, n_octaves, base)

    def sample(x, y):
        out = np.zeros_like(x, dtype=np.float64)
        norm = 0.0
        for res, g, amp in grids:
            fx = (x % 1.0) * res
            fy = (y % 1.0) * res
            ix = np.clip(fx.astype(np.int64), 0, res)
            iy = np.clip(fy.astype(np.int64), 0, res)
            tx = fx - ix
            ty = fy - iy
            tx = tx * tx * (3 - 2 * tx)
            ty = ty * ty * (3 - 2 * ty)
            v00 = g[iy, ix]
            v01 = g[iy, ix + 1]
            v10 = g[iy + 1, ix]
            v11 = g[iy + 1, ix + 1]
            out += amp * ((v00 * (1 - tx) + v01 * tx) * (1 - ty) + (v10 * (1 - tx) + v11 * tx) * ty)
            norm += amp
        return out / norm

    return sample


@dataclasses.dataclass
class WaveField:
    """Sum-of-sinusoids directional sea surface z = eta(x, y)."""

    amps: np.ndarray
    kx: np.ndarray
    ky: np.ndarray
    phases: np.ndarray

    @staticmethod
    def random(rng: np.random.Generator, amplitude: float = 0.08, n_waves: int = 24, kmin: float = 0.05, kmax: float = 1.2):
        k = np.exp(rng.uniform(np.log(kmin), np.log(kmax), n_waves))
        theta = rng.normal(0.0, 0.6, n_waves)
        # Longer waves carry more energy (omnidirectional-ish spectrum);
        # scaled so std(eta) == amplitude.
        amps = (kmin / k) ** 0.8
        amps *= amplitude / np.sqrt(np.sum(0.5 * amps**2) + 1e-30)
        return WaveField(
            amps=amps,
            kx=k * np.cos(theta),
            ky=k * np.sin(theta),
            phases=rng.uniform(0, 2 * np.pi, n_waves),
        )

    def eta(self, x: np.ndarray, y: np.ndarray, t: float = 0.0) -> np.ndarray:
        out = np.zeros_like(x, dtype=np.float64)
        for a, kx, ky, ph in zip(self.amps, self.kx, self.ky, self.phases):
            omega = np.sqrt(9.81 * np.hypot(kx, ky))
            out += a * np.cos(kx * x + ky * y + ph - omega * t)
        return out


# --------------------------------------------------------------------------
# Rig
# --------------------------------------------------------------------------


@dataclasses.dataclass
class SyntheticRig:
    """Two pinhole cameras in the world frame."""

    K0: np.ndarray
    K1: np.ndarray
    R0: np.ndarray  # world -> cam0
    T0: np.ndarray
    R1: np.ndarray  # world -> cam1
    T1: np.ndarray
    width: int
    height: int
    dist0: Optional[np.ndarray] = None
    dist1: Optional[np.ndarray] = None

    @property
    def R(self) -> np.ndarray:
        """Relative rotation: x_cam1 = R x_cam0 + T."""
        return self.R1 @ self.R0.T

    @property
    def T(self) -> np.ndarray:
        return self.T1 - self.R @ self.T0

    @property
    def baseline(self) -> float:
        return float(np.linalg.norm(self.T))

    def plane_cam0(self) -> np.ndarray:
        """Sea mean plane (z_w = 0) as (a, b, c, d) in cam0 coords with the
        normal facing the camera (+z component, matching PovMesh convention)."""
        n_w = np.array([0.0, 0.0, 1.0])
        n_c = self.R0 @ n_w
        # plane: n_c . x_c + d = 0 for x_c = R0 x_w + T0 with n_w . x_w = 0
        d = -float(n_c @ self.T0)
        if n_c[2] < 0:
            n_c, d = -n_c, -d
        return np.array([n_c[0], n_c[1], n_c[2], d])


def make_rig(
    width: int = 256,
    height: int = 192,
    focal_px: Optional[float] = None,
    cam_height: float = 10.0,
    look_down_deg: float = 25.0,
    baseline: float = 2.5,
    toe_in_deg: float = 1.0,
) -> SyntheticRig:
    # Deterministic: the principal-point jitters below are fixed, so every
    # call with the same arguments produces the identical canonical rig.
    f = focal_px if focal_px is not None else 1.1 * width
    K = lambda jx, jy: np.array(
        [[f, 0.0, width / 2 + jx], [0.0, f, height / 2 + jy], [0.0, 0.0, 1.0]]
    )

    def look(cam_pos, down_deg, yaw_deg):
        """world->cam rotation for a camera looking +y (north), pitched down."""
        cp = np.deg2rad(down_deg)
        cy = np.deg2rad(yaw_deg)
        # camera axes in world coords: x right, y down-ish, z forward
        fwd = np.array([np.sin(cy) * np.cos(cp), np.cos(cy) * np.cos(cp), -np.sin(cp)])
        right = np.array([np.cos(cy), -np.sin(cy), 0.0])
        down = np.cross(fwd, right)
        Rwc = np.stack([right, down, fwd])  # rows = cam axes
        t = -Rwc @ cam_pos
        return Rwc, t

    p0 = np.array([-baseline / 2, 0.0, cam_height])
    p1 = np.array([+baseline / 2, 0.0, cam_height])
    R0, T0 = look(p0, look_down_deg, +toe_in_deg)
    R1, T1 = look(p1, look_down_deg, -toe_in_deg)
    return SyntheticRig(K(0.5, -0.3), K(-0.4, 0.2), R0, T0, R1, T1, width, height)


# --------------------------------------------------------------------------
# Rendering
# --------------------------------------------------------------------------


@dataclasses.dataclass
class SyntheticScene:
    rig: SyntheticRig
    waves: WaveField
    img0: np.ndarray  # (H, W) float in [0, 255]
    img1: np.ndarray
    depth0: np.ndarray  # per-pixel z in cam0 frame (nan where no hit)
    points0: np.ndarray  # (H, W, 3) per-pixel 3D points in cam0 frame
    texture_scale: float

    def eta_cam0(self, pts_cam0: np.ndarray) -> np.ndarray:
        """Ground-truth world elevation for cam0-frame points (for error
        metrics): returns eta(x_w, y_w) - z_w (0 for exact surface points)."""
        R0, T0 = self.rig.R0, self.rig.T0
        pw = (pts_cam0 - T0) @ R0
        return self.waves.eta(pw[..., 0], pw[..., 1]) - pw[..., 2]

    def elevation_error(self, pts_cam0: np.ndarray, plane: np.ndarray) -> np.ndarray:
        """verify_meshes.m-style elevation error (reference
        test/verify_meshes.m:14-30): both the reconstructed
        points and the ground truth are aligned to the *same estimated* sea
        plane, so global calibration tilt cancels exactly as in the
        reference's acceptance test.

        Args:
          pts_cam0: (N, 3) reconstructed points, cam0 frame, baseline units.
          plane: (4,) estimated plane (cam0 frame, baseline units).
        Returns per-point |z_rec - z_gt| in baseline units (NaN where the
        point projects outside the image).
        """
        K0 = self.rig.K0
        b = self.rig.baseline
        # Ground-truth 3D point along the same cam0 ray: sample the GT
        # point map at the reconstructed point's projection.
        uv = pts_cam0 @ K0.T
        uv = uv[:, :2] / uv[:, 2:3]
        H, W = self.depth0.shape
        x = np.clip(uv[:, 0], 0, W - 1.001)
        y = np.clip(uv[:, 1], 0, H - 1.001)
        x0 = np.floor(x).astype(int)
        y0 = np.floor(y).astype(int)
        fx = (x - x0)[:, None]
        fy = (y - y0)[:, None]
        P = self.points0
        gt = (
            P[y0, x0] * (1 - fx) * (1 - fy)
            + P[y0, x0 + 1] * fx * (1 - fy)
            + P[y0 + 1, x0] * (1 - fx) * fy
            + P[y0 + 1, x0 + 1] * fx * fy
        ) / b
        inb = (uv[:, 0] >= 0) & (uv[:, 0] < W - 1) & (uv[:, 1] >= 0) & (uv[:, 1] < H - 1)

        # Align both clouds by the same estimated plane (plane frame z).
        a, bb, c, d = plane
        n = np.array([a, bb, c])
        z_rec = pts_cam0 @ n + d
        z_gt = gt @ n + d
        err = np.abs(z_rec - z_gt)
        return np.where(inb, err, np.nan)


def _trace_rays(origin: np.ndarray, dirs: np.ndarray, waves: WaveField, iters: int = 30):
    """Intersect rays origin + t*dirs with z = eta(x, y); returns t (nan if
    pointing away from the surface)."""
    vz = dirs[..., 2]
    # Initial guess: intersection with the mean plane.
    with np.errstate(divide="ignore", invalid="ignore"):
        t = -origin[2] / vz
    bad = (vz >= -1e-6) | (t <= 0)
    t = np.where(bad, np.nan, t)
    for _ in range(iters):
        p = origin[None, None, :] + t[..., None] * dirs
        h = waves.eta(p[..., 0], p[..., 1])
        # Move along the ray to the surface elevation at the current (x, y).
        t = t + (h - p[..., 2]) / vz
    return t


def _render(rig, waves, tex, tex_scale, K, Rwc, t, xy=None):
    """Trace one camera's pixels: (image, points in the camera frame,
    world points).  xy: the normalized image coordinates of the rays, by
    default those of the pinhole pixel grid."""
    cam_pos = -Rwc.T @ t
    if xy is None:
        H, W = rig.height, rig.width
        u = np.arange(W, dtype=np.float64)
        v = np.arange(H, dtype=np.float64)
        uu, vv = np.meshgrid(u, v)
        xy = ((uu - K[0, 2]) / K[0, 0], (vv - K[1, 2]) / K[1, 1])
    rays_cam = np.stack([xy[0], xy[1], np.ones_like(xy[0])], axis=-1)
    rays_w = rays_cam @ Rwc  # R^T @ ray
    rays_w /= np.linalg.norm(rays_w, axis=-1, keepdims=True)
    tt = _trace_rays(cam_pos, rays_w, waves)
    pw = cam_pos[None, None, :] + tt[..., None] * rays_w
    # Shading: texture + slope-dependent lambert-ish term for realism.
    base = tex(pw[..., 0] * tex_scale, pw[..., 1] * tex_scale)
    img = 30.0 + 200.0 * base
    img = np.where(np.isfinite(tt), img, 0.0)
    pc = pw @ Rwc.T + t  # points in this camera's frame
    return np.clip(img, 0, 255), pc, pw


def undistorted_rays(K: np.ndarray, dist, height: int, width: int, iters: int = 20):
    """Normalized undistorted coordinates (x, y) of every pixel of a camera
    with OpenCV distortion `dist` (k1, k2, p1, p2[, k3[, k4, k5, k6]]):
    the fixed-point inverse of the model, in float64."""
    d = np.zeros(8)
    d[: len(np.ravel(dist))] = np.ravel(dist)
    k1, k2, p1, p2, k3, k4, k5, k6 = d
    uu, vv = np.meshgrid(np.arange(width, dtype=np.float64), np.arange(height, dtype=np.float64))
    xd, yd = (uu - K[0, 2]) / K[0, 0], (vv - K[1, 2]) / K[1, 1]
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        radial = (1 + k1 * r2 + k2 * r2**2 + k3 * r2**3) / (1 + k4 * r2 + k5 * r2**2 + k6 * r2**3)
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x, y = (xd - dx) / radial, (yd - dy) / radial
    return x, y


def render_raw(seed: int, rig: "SyntheticRig", dist0, dist1, wave_amplitude: float = 0.08,
               texture_octaves: int = 7):
    """The raw frames (img0, img1) of make_scene(seed, rig=rig,
    wave_amplitude=...)'s surface seen through lenses with OpenCV
    distortions dist0 / dist1: every raw pixel is traced along the ray of
    its undistorted position, so the prepare stage's undistortion (one
    resampling) gives back the pinhole images of make_scene.  Row blocks
    render on 8 threads (numpy's elementwise loops release the interpreter
    lock): a 3 MP pair in ~36 s on an 8-core host."""
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(seed)  # replays make_scene's draws
    waves = WaveField.random(rng, amplitude=wave_amplitude)
    tex = _value_noise(rng, n_octaves=texture_octaves, base=8)
    H = rig.height
    blocks = [(r, min(r + 64, H)) for r in range(0, H, 64)]
    out = []
    with ThreadPoolExecutor(8) as pool:
        for K, Rwc, t, dist in ((rig.K0, rig.R0, rig.T0, dist0), (rig.K1, rig.R1, rig.T1, dist1)):
            x, y = undistorted_rays(K, dist, H, rig.width)
            parts = pool.map(lambda b: _render(rig, waves, tex, 1.0 / 60.0, K, Rwc, t, (x[b[0]:b[1]], y[b[0]:b[1]]))[0],
                             blocks)
            out.append(np.concatenate(list(parts)).astype(np.float32))
    return out[0], out[1]


def make_scene(
    seed: int = 0,
    width: int = 256,
    height: int = 192,
    wave_amplitude: float = 0.08,
    time: float = 0.0,
    rig: Optional[SyntheticRig] = None,
    texture_octaves: int = 7,
) -> SyntheticScene:
    rng = np.random.default_rng(seed)
    rig = rig or make_rig(width=width, height=height)
    waves = WaveField.random(rng, amplitude=wave_amplitude)
    # Texture field over world xy; scale chosen so the finest octave is a few
    # pixels on screen at the working distance.
    tex = _value_noise(rng, n_octaves=texture_octaves, base=8)
    tex_scale = 1.0 / 60.0  # world units -> texture units

    def render(K, Rwc, t):
        return _render(rig, waves, tex, tex_scale, K, Rwc, t)

    img0, pc0, pw0 = render(rig.K0, rig.R0, rig.T0)
    img1, _, _ = render(rig.K1, rig.R1, rig.T1)
    depth0 = pc0[..., 2]
    return SyntheticScene(
        rig=rig,
        waves=waves,
        img0=img0.astype(np.float32),
        img1=img1.astype(np.float32),
        depth0=depth0,
        points0=pc0,
        texture_scale=tex_scale,
    )


def render_pair(seed: int, rig: SyntheticRig, device, wave_amplitude: float = 0.08, texture_octaves: int = 7):
    """make_scene(seed, rig=rig, wave_amplitude=...)'s images (img0, img1),
    traced with torch in float64 on `device` (the same draws and the same
    arithmetic as _render, so equal to make_scene's up to the last bits of
    the device's cos): a 3 MP pair in well under a second on a card, where
    make_scene takes minutes on the host.  No ground truth."""
    import torch

    rng = np.random.default_rng(seed)  # replays make_scene's draws
    waves = WaveField.random(rng, amplitude=wave_amplitude)
    grids = [(res, torch.as_tensor(g, device=device), amp)
             for res, g, amp in _noise_grids(rng, texture_octaves, 8)]
    f64 = dict(dtype=torch.float64, device=device)

    def eta(x, y):
        out = torch.zeros_like(x)
        for a, kx, ky, ph in zip(*(w.tolist() for w in (waves.amps, waves.kx, waves.ky, waves.phases))):
            omega = float(np.sqrt(9.81 * np.hypot(kx, ky)))
            out += a * torch.cos(kx * x + ky * y + ph - omega * 0.0)
        return out

    def noise(x, y):
        out, norm = torch.zeros_like(x), 0.0
        for res, g, amp in grids:
            fx, fy = torch.remainder(x, 1.0) * res, torch.remainder(y, 1.0) * res
            ix, iy = fx.long().clamp(0, res), fy.long().clamp(0, res)
            tx, ty = fx - ix, fy - iy
            tx, ty = tx * tx * (3 - 2 * tx), ty * ty * (3 - 2 * ty)
            out += amp * ((g[iy, ix] * (1 - tx) + g[iy, ix + 1] * tx) * (1 - ty)
                          + (g[iy + 1, ix] * (1 - tx) + g[iy + 1, ix + 1] * tx) * ty)
            norm += amp
        return out / norm

    vv, uu = torch.meshgrid(torch.arange(rig.height, **f64), torch.arange(rig.width, **f64), indexing="ij")
    images = []
    for K, Rwc, t in ((rig.K0, rig.R0, rig.T0), (rig.K1, rig.R1, rig.T1)):
        cam_pos = torch.as_tensor(-Rwc.T @ t, **f64)
        rays = torch.stack([(uu - K[0, 2]) / K[0, 0], (vv - K[1, 2]) / K[1, 1], torch.ones_like(uu)], -1)
        rays = rays @ torch.as_tensor(Rwc, **f64)
        rays /= torch.linalg.norm(rays, dim=-1, keepdim=True)
        vz = rays[..., 2]
        tt = -cam_pos[2] / vz
        tt = torch.where((vz >= -1e-6) | (tt <= 0), torch.nan, tt)
        for _ in range(30):
            pw = cam_pos + tt[..., None] * rays
            tt = tt + (eta(pw[..., 0], pw[..., 1]) - pw[..., 2]) / vz
        pw = cam_pos + tt[..., None] * rays
        img = 30.0 + 200.0 * noise(pw[..., 0] / 60.0, pw[..., 1] / 60.0)
        img = torch.where(torch.isfinite(tt), img, 0.0)
        images.append(torch.clamp(img, 0, 255).float().cpu().numpy())
    return images[0], images[1]
