"""Small gridded cubes for the port's post tests: the grid and meta of a
grid setup on write_grid_sequence's workdirs (96x64 frames, their
undistorted PNG in cam0images), Z a directional wave field in mm at the
grid's nodes, with NaN holes, written by the port's NetCDFWriter."""

from pathlib import Path

import numpy as np

from wass_tpu_torch.grid.netcdf import NetCDFWriter
from wass_tpu_torch.grid.setup import grid_setup
from wass_tpu_torch.io.workdir import frame_workdirs

from torch_grid_data import BASELINE, write_grid_sequence

FPS = 4.0


def wave_cube(XX: np.ndarray, YY: np.ndarray, n_frames: int, fps: float, seed: int) -> np.ndarray:
    """(T, H, W) heights in m of a sum of directional waves (deep water
    dispersion) at the nodes XX, YY (m) and t = i / fps."""
    rng = np.random.default_rng(seed)
    k = rng.uniform(0.3, 1.5, 8)
    th = rng.normal(0.0, 0.5, 8)
    amp = rng.uniform(0.02, 0.12, 8)
    ph = rng.uniform(0, 2 * np.pi, 8)
    t = np.arange(n_frames)[:, None, None] / fps
    Z = np.zeros((n_frames,) + XX.shape)
    for a, kk, tt, p in zip(amp, k, th, ph):
        Z += a * np.cos(kk * np.cos(tt) * XX + kk * np.sin(tt) * YY + p - np.sqrt(9.81 * kk) * t)
    return Z


def write_post_cube(root, n_frames: int = 96, N: int = 40, seed: int = 0, holes: bool = True) -> Path:
    """root/seq (one workdir) and root/gridded.nc: N x N, n_frames frames at
    FPS, Z in mm (NaN in a patch of some frames and at one cell of every
    frame when `holes`), every frame's cam0images the workdir's
    undistorted cam 0 PNG.  Returns the cube's path."""
    root = Path(root)
    write_grid_sequence(root / "seq", n_frames=1)
    wd = frame_workdirs(root / "seq")[0]
    plane = wd.load_plane()
    setup = grid_setup(wd, plane, BASELINE, area_center=(0.0, -16.0), area_size_x=10.0, area_size_y=10.0,
                       Nx=N, Ny=N, fps=FPS)
    Z = wave_cube(setup.XX, setup.YY, n_frames, FPS, seed) * 1000.0
    if holes:
        Z[3:9, 5:9, 30:34] = np.nan
        Z[:, N - 3, 2] = np.nan
    image = wd.undistorted_path(0).read_bytes()
    path = root / "gridded.nc"
    w = NetCDFWriter(path, M=N, N=N, count=n_frames)
    w.scale = setup.baseline
    w.set_grids(setup.XX * 1000.0, setup.YY * 1000.0)
    w.set_kxky(setup.KX_ab, setup.KY_ab)
    w.set_intrinsics(setup.K0, setup.K1, np.zeros(5), np.zeros(5), setup.P0plane, setup.P1plane, setup.P0cam[:3],
                     setup.P1cam[:3], setup.Cam0toGrid, setup.Cam1toGrid)
    w.add_meta_attribute("generator", "wass_tpu")
    w.add_meta_attribute("baseline", setup.baseline)
    w.add_meta_attribute("fps", FPS)
    w.set_mask(np.ones((N, N), np.float32))
    w.add_meta_attribute("image_width", 96)
    w.add_meta_attribute("image_height", 64)
    for i in range(n_frames):
        w.push_Z(Z[i], time=i / FPS, workdir=i, image=image)
    w.add_meta_attribute("zmin", float(np.nanmin(Z)))
    w.add_meta_attribute("zmax", float(np.nanmax(Z)))
    w.close()
    return path
