"""The benchmark's input generator: consecutive frames of one synthetic sea
seen by a known stereo rig, traced on the device from a seed.

A copy of wass_tpu_torch/testing/synthetic.py's render_pair (with its
make_rig, WaveField.random and value-noise draws), frozen here so that a
change of the program cannot change the benchmark's inputs, with two
additions: a time argument (the waves move, the texture stays on the
water), and the per-pixel ground-truth surface points of camera 0, which
the accuracy line scores the reconstructed meshes against (the
verify_meshes elevation error).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def _noise_grids(rng: np.random.Generator, n_octaves: int, base: int) -> list:
    """The value noise's (resolution, lattice, amplitude) per octave."""
    grids = []
    for o in range(n_octaves):
        res = base * (2**o)
        grids.append((res, rng.random((res + 2, res + 2)), 0.55**o))
    return grids


@dataclasses.dataclass
class WaveField:
    """Sum-of-sinusoids directional sea surface z = eta(x, y, t)."""

    amps: np.ndarray
    kx: np.ndarray
    ky: np.ndarray
    phases: np.ndarray

    @staticmethod
    def random(rng: np.random.Generator, amplitude: float = 0.08, n_waves: int = 24, kmin: float = 0.05,
               kmax: float = 1.2) -> "WaveField":
        k = np.exp(rng.uniform(np.log(kmin), np.log(kmax), n_waves))
        theta = rng.normal(0.0, 0.6, n_waves)
        amps = (kmin / k) ** 0.8
        amps *= amplitude / np.sqrt(np.sum(0.5 * amps**2) + 1e-30)
        return WaveField(amps=amps, kx=k * np.cos(theta), ky=k * np.sin(theta),
                         phases=rng.uniform(0, 2 * np.pi, n_waves))


@dataclasses.dataclass
class Rig:
    """Two pinhole cameras in the world frame (x_cam = R x_world + T)."""

    K0: np.ndarray
    K1: np.ndarray
    R0: np.ndarray
    T0: np.ndarray
    R1: np.ndarray
    T1: np.ndarray
    width: int
    height: int

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


def make_rig(width: int, height: int, focal_px: Optional[float] = None, cam_height: float = 10.0,
             look_down_deg: float = 25.0, baseline: float = 2.5, toe_in_deg: float = 1.0) -> Rig:
    """The port's synthetic rig (testing/synthetic.py:make_rig): two cameras
    cam_height above the sea, baseline apart, pitched down, toed in."""
    f = focal_px if focal_px is not None else 1.1 * width

    def K(jx, jy):
        return np.array([[f, 0.0, width / 2 + jx], [0.0, f, height / 2 + jy], [0.0, 0.0, 1.0]])

    def look(cam_pos, down_deg, yaw_deg):
        cp, cy = np.deg2rad(down_deg), np.deg2rad(yaw_deg)
        fwd = np.array([np.sin(cy) * np.cos(cp), np.cos(cy) * np.cos(cp), -np.sin(cp)])
        right = np.array([np.cos(cy), -np.sin(cy), 0.0])
        down = np.cross(fwd, right)
        Rwc = np.stack([right, down, fwd])
        return Rwc, -Rwc @ cam_pos

    R0, T0 = look(np.array([-baseline / 2, 0.0, cam_height]), look_down_deg, +toe_in_deg)
    R1, T1 = look(np.array([+baseline / 2, 0.0, cam_height]), look_down_deg, -toe_in_deg)
    return Rig(K(0.5, -0.3), K(-0.4, 0.2), R0, T0, R1, T1, width, height)


def rig_from_config(cfg: dict) -> Rig:
    return make_rig(cfg["width"], cfg["height"], **cfg.get("rig", {}))


class Sea:
    """One sea state drawn from a seed (the draws of make_scene(seed)):
    pair(t) traces both cameras' images at time t, and camera 0's surface
    points."""

    def __init__(self, seed: int, rig: Rig, device, wave_amplitude: float, texture_octaves: int = 7):
        rng = np.random.default_rng(seed)
        self.rig = rig
        self.device = torch.device(device)
        self.waves = WaveField.random(rng, amplitude=wave_amplitude)
        self.grids = [(res, torch.as_tensor(g, device=self.device), amp)
                      for res, g, amp in _noise_grids(rng, texture_octaves, 8)]

    def _eta(self, x, y, t: float):
        out = torch.zeros_like(x)
        w = self.waves
        for a, kx, ky, ph in zip(*(v.tolist() for v in (w.amps, w.kx, w.ky, w.phases))):
            omega = float(np.sqrt(9.81 * np.hypot(kx, ky)))
            out += a * torch.cos(kx * x + ky * y + ph - omega * t)
        return out

    def _noise(self, x, y):
        out, norm = torch.zeros_like(x), 0.0
        for res, g, amp in self.grids:
            fx, fy = torch.remainder(x, 1.0) * res, torch.remainder(y, 1.0) * res
            ix, iy = fx.long().clamp(0, res), fy.long().clamp(0, res)
            tx, ty = fx - ix, fy - iy
            tx, ty = tx * tx * (3 - 2 * tx), ty * ty * (3 - 2 * ty)
            out += amp * ((g[iy, ix] * (1 - tx) + g[iy, ix + 1] * tx) * (1 - ty)
                          + (g[iy + 1, ix] * (1 - tx) + g[iy + 1, ix + 1] * tx) * ty)
            norm += amp
        return out / norm

    def pair(self, t: float = 0.0, with_points: bool = False):
        """(img0, img1) float32 numpy images in [0, 255] at time t, and, with
        with_points, camera 0's (H, W, 3) float64 surface points in its own
        frame (NaN where a ray misses the sea), on the device."""
        rig = self.rig
        f64 = dict(dtype=torch.float64, device=self.device)
        vv, uu = torch.meshgrid(torch.arange(rig.height, **f64), torch.arange(rig.width, **f64), indexing="ij")
        images, points = [], None
        for cam, (K, Rwc, tvec) in enumerate(((rig.K0, rig.R0, rig.T0), (rig.K1, rig.R1, rig.T1))):
            cam_pos = torch.as_tensor(-Rwc.T @ tvec, **f64)
            rays = torch.stack([(uu - K[0, 2]) / K[0, 0], (vv - K[1, 2]) / K[1, 1], torch.ones_like(uu)], -1)
            rays = rays @ torch.as_tensor(Rwc, **f64)
            rays /= torch.linalg.norm(rays, dim=-1, keepdim=True)
            vz = rays[..., 2]
            tt = -cam_pos[2] / vz
            tt = torch.where((vz >= -1e-6) | (tt <= 0), torch.nan, tt)
            for _ in range(30):
                pw = cam_pos + tt[..., None] * rays
                tt = tt + (self._eta(pw[..., 0], pw[..., 1], t) - pw[..., 2]) / vz
            pw = cam_pos + tt[..., None] * rays
            img = 30.0 + 200.0 * self._noise(pw[..., 0] / 60.0, pw[..., 1] / 60.0)
            img = torch.where(torch.isfinite(tt), img, 0.0)
            images.append(torch.clamp(img, 0, 255).float().cpu().numpy())
            if with_points and cam == 0:
                points = pw @ torch.as_tensor(Rwc.T, **f64) + torch.as_tensor(tvec, **f64)
            del pw, rays, tt
        return images[0], images[1], points


def to_u8(img: np.ndarray) -> np.ndarray:
    """An image as 8-bit pixels, truncated as the workdir writers store them."""
    return np.clip(img, 0, 255).astype(np.uint8)


def elevation_error(points0: torch.Tensor, K0: np.ndarray, baseline: float, mesh: np.ndarray,
                    plane: np.ndarray) -> float:
    """verify_meshes' trimmed-mean elevation error, in baseline units, of a
    reconstructed camera-0 mesh (N, 3) with its plane against the traced
    ground truth: each point's ground truth is the bilinear sample of the
    surface-point map at its projection, both clouds aligned to the same
    estimated plane, and the mean taken over the smallest 99.9% of
    |z_rec - z_gt| (the reference's gate: < 0.02).  A copy of the port's
    testing/__init__.py:trimmed_elevation_error over the traced points."""
    P = points0.detach().cpu().numpy()
    pts = np.asarray(mesh, np.float64)
    uv = pts @ np.asarray(K0, np.float64).T
    uv = uv[:, :2] / uv[:, 2:3]
    H, W = P.shape[:2]
    x = np.clip(uv[:, 0], 0, W - 1.001)
    y = np.clip(uv[:, 1], 0, H - 1.001)
    x0, y0 = np.floor(x).astype(int), np.floor(y).astype(int)
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    gt = (P[y0, x0] * (1 - fx) * (1 - fy) + P[y0, x0 + 1] * fx * (1 - fy)
          + P[y0 + 1, x0] * (1 - fx) * fy + P[y0 + 1, x0 + 1] * fx * fy) / baseline
    inb = (uv[:, 0] >= 0) & (uv[:, 0] < W - 1) & (uv[:, 1] >= 0) & (uv[:, 1] < H - 1)
    n, d = np.asarray(plane[:3], np.float64), float(plane[3])
    err = np.where(inb, np.abs((pts @ n + d) - (gt @ n + d)), np.nan)
    ae = np.sort(err[np.isfinite(err)])
    return float(ae[: int(len(ae) * 0.999)].mean()) if len(ae) else float("nan")
