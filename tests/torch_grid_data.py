"""Small gridding inputs for the port's grid tests: frame workdirs whose
mesh_cam.xyzC hold make_scene's ground-truth points (no stereo run), in
the layout the stereo stage writes; and the JAX package's random draws,
which the port's grid functions take as tensors."""

from pathlib import Path

import numpy as np

from wass_tpu_torch.grid.setup import compute_sea_plane_RT
from wass_tpu_torch.io.workdir import Workdir
from wass_tpu_torch.testing.synthetic import make_rig, make_scene

WIDTH, HEIGHT = 96, 64
BASELINE = 2.5  # make_rig's baseline, meters
AREA = ("0,-16", "10")  # --area_center, --area_size (meters) inside the meshes' footprint


def write_grid_sequence(seq, n_frames: int = 3, seed: int = 300) -> list:
    """n_frames workdirs of one rig at times 0, 0.25, ...: undistorted
    images, intrinsics, P0cam/P1cam, plane.txt and the mesh (baseline
    units, the sea-plane payload with its inverse transform)."""
    seq = Path(seq)
    rig = make_rig(width=WIDTH, height=HEIGHT)
    b = rig.baseline
    plane = rig.plane_cam0()
    plane[3] /= b
    R, T = compute_sea_plane_RT(plane)
    wds = []
    for i in range(n_frames):
        sc = make_scene(seed=seed + i, width=WIDTH, height=HEIGHT, wave_amplitude=0.25, rig=rig, time=0.25 * i)
        wd = Workdir(seq / f"{i:06d}_wd").create()
        wd.save_undistorted(0, sc.img0)
        wd.save_undistorted(1, sc.img1)
        wd.save_intrinsics(0, rig.K0)
        wd.save_intrinsics(1, rig.K1)
        wd.save_projection_matrices(rig.K0 @ np.hstack([np.eye(3), np.zeros((3, 1))]),
                                    rig.K1 @ np.hstack([rig.R, rig.T.reshape(3, 1) / b]))
        pts = sc.points0.reshape(-1, 3)
        pts = pts[np.isfinite(pts).all(axis=1)] / b
        wd.save_plane(plane)
        wd.save_mesh(pts @ R.T + T.T, R.T, -R.T @ T)
        wds.append(wd)
    return wds


def jax_perms(seed: int, nreps: int, npts: int, n_use: int) -> np.ndarray:
    """The subsamples wass_tpu.grid.gridding._median_stack draws: one
    permutation of the points a key of jax.random.split(PRNGKey(seed),
    nreps), cut to n_use."""
    import jax

    keys = jax.random.split(jax.random.PRNGKey(seed), nreps)
    return np.array(jax.vmap(lambda k: jax.random.permutation(k, npts)[:n_use])(keys))


def jax_x0(seed: int, nfreqs: int) -> np.ndarray:
    """wass_tpu.grid.interpolators._dct_optimize's initial coefficients."""
    import jax
    import jax.numpy as jnp

    return np.array(jax.random.uniform(jax.random.PRNGKey(seed), (nfreqs, nfreqs), jnp.float32))


def use_jax_draws(monkeypatch) -> None:
    """Make the port's grid stage draw the JAX package's subsamples and
    initial DCT coefficients."""
    import torch

    import wass_tpu_torch.grid.gridding as tg
    import wass_tpu_torch.grid.interpolators as ti

    monkeypatch.setattr(tg, "median_draws", lambda npts, nreps, n_use, seed, device: torch.as_tensor(
        jax_perms(seed, nreps, npts, n_use), device=device))
    monkeypatch.setattr(ti, "dct_x0", lambda nfreqs, seed, device: torch.as_tensor(jax_x0(seed, nfreqs),
                                                                                   device=device))
