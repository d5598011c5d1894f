"""Grid-geometry setup (wassgridsurface --action setup equivalent).

Re-derivation of setup()
(gridding/wassgridsurface/wassgridsurface.py:57-231): from
one reference workdir and the sequence mean plane, build the sea-plane
aligned XY grid, the normalized projection matrices P0plane/P1plane, the
camera->grid transforms, the wavenumber grids, and persist everything as
config.mat (scipy.io) so reference tooling can consume it.

The port's own copy of the JAX package's wass_tpu/grid/setup.py, float64
numpy on the host with the same behaviour, plus GridSetup.load_mat (the
JAX console's inline loadmat block); file references are to the WASS
reference sources.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from wass_tpu_torch.io.matrices import load_matrix_txt
from wass_tpu_torch.io.workdir import Workdir
from wass_tpu_torch.io.xyzc import load_camera_mesh


def compute_sea_plane_RT(plane: np.ndarray):
    """wass_utils.compute_sea_plane_RT (gridding/wassgridsurface/wass_utils.py:38-48)."""
    a, b, c, d = np.asarray(plane, np.float64).reshape(4)
    q = (1 - c) / (a * a + b * b)
    R = np.array([[1 - a * a * q, -a * b * q, -a], [-a * b * q, 1 - b * b * q, -b], [a, b, c]])
    T = np.array([[0.0], [0.0], [d]])
    return R, T


def align_on_sea_plane(mesh: np.ndarray, plane: np.ndarray) -> np.ndarray:
    """Camera mesh (3, N) -> sea-plane frame with inverted z (z up)."""
    R, T = compute_sea_plane_RT(plane)
    out = R @ mesh + T
    out[2, :] *= -1.0
    return out


def _scalar(m: dict, key: str) -> float:
    return float(np.ravel(m[key])[0])


@dataclasses.dataclass
class GridSetup:
    XX: np.ndarray
    YY: np.ndarray
    KX_ab: np.ndarray
    KY_ab: np.ndarray
    Rpl: np.ndarray
    Tpl: np.ndarray
    P0cam: np.ndarray
    P1cam: np.ndarray
    P0plane: np.ndarray
    P1plane: np.ndarray
    Cam0toGrid: np.ndarray
    Cam1toGrid: np.ndarray
    K0: np.ndarray
    K1: np.ndarray
    baseline: float
    xmin: float
    xmax: float
    ymin: float
    ymax: float
    zmin: float
    zmax: float
    x_spacing: float
    y_spacing: float
    fps: float
    timestring: str = ""

    def save_mat(self, path) -> None:
        import scipy.io as sio

        Nx = self.XX.shape[1]
        Ny = self.XX.shape[0]
        sio.savemat(
            str(path),
            {
                "xmin": self.xmin, "xmax": self.xmax,
                "ymin": self.ymin, "ymax": self.ymax,
                "zmin": self.zmin, "zmax": self.zmax,
                "P0cam": self.P0cam[:3, :], "P1cam": self.P1cam[:3, :],
                "Cam0toGrid": self.Cam0toGrid, "Cam1toGrid": self.Cam1toGrid,
                "Nx": Nx, "Ny": Ny, "N": max(Nx, Ny),
                "RTplane": self.RTplane,
                "K0": self.K0, "K1": self.K1,
                "Rpl": self.Rpl, "Tpl": self.Tpl,
                "P0plane": self.P0plane, "P1plane": self.P1plane,
                "CAM_BASELINE": self.baseline, "scale": self.baseline,
                "XX": self.XX, "YY": self.YY,
                "KX_ab": self.KX_ab, "KY_ab": self.KY_ab,
                "spec_scale": 1.0 / (Nx * Ny),
                "x_spacing": self.x_spacing, "y_spacing": self.y_spacing,
                "fps": self.fps, "timestring": self.timestring,
            },
        )

    @classmethod
    def load_mat(cls, path) -> "GridSetup":
        """The setup that save_mat wrote (the JAX console reads config.mat
        the same way, wass_tpu/cli/gridsurface.py:82-95; timestring is not
        read back there either)."""
        import scipy.io as sio

        m = sio.loadmat(str(path))
        return cls(
            XX=m["XX"], YY=m["YY"], KX_ab=m["KX_ab"], KY_ab=m["KY_ab"],
            Rpl=m["Rpl"], Tpl=m["Tpl"],
            P0cam=np.vstack([m["P0cam"], [0, 0, 0, 1]]), P1cam=np.vstack([m["P1cam"], [0, 0, 0, 1]]),
            P0plane=m["P0plane"], P1plane=m["P1plane"],
            Cam0toGrid=m["Cam0toGrid"], Cam1toGrid=m["Cam1toGrid"],
            K0=m["K0"], K1=m["K1"], baseline=_scalar(m, "CAM_BASELINE"),
            xmin=_scalar(m, "xmin"), xmax=_scalar(m, "xmax"),
            ymin=_scalar(m, "ymin"), ymax=_scalar(m, "ymax"),
            zmin=_scalar(m, "zmin"), zmax=_scalar(m, "zmax"),
            x_spacing=_scalar(m, "x_spacing"), y_spacing=_scalar(m, "y_spacing"),
            fps=_scalar(m, "fps"),
        )

    @property
    def RTplane(self) -> np.ndarray:
        Ri = self.Rpl.T
        Ti = -self.Rpl.T @ self.Tpl
        return np.vstack([np.hstack([Ri, Ti]), [0, 0, 0, 1]])


def grid_setup(
    workdir: Workdir,
    meanplane: np.ndarray,
    baseline: float,
    area_center: Tuple[float, float],
    area_size_x: float,
    area_size_y: float,
    Nx: int,
    Ny: int,
    image_size: Optional[Tuple[int, int]] = None,
    fps: float = 0.0,
    timestring: str = "",
) -> GridSetup:
    """Build grid geometry (wassgridsurface.py:57-231 semantics)."""
    K0 = workdir.load_intrinsics(0)
    K1 = workdir.load_intrinsics(1)

    P0cam = np.vstack([load_matrix_txt(workdir.path / "P0cam.txt"), [0, 0, 0, 1]])
    P1cam = np.vstack([load_matrix_txt(workdir.path / "P1cam.txt"), [0, 0, 0, 1]])

    if image_size is None:
        img = workdir.load_undistorted(0)
        Ih, Iw = img.shape
    else:
        Iw, Ih = image_size

    Rpl, Tpl = compute_sea_plane_RT(meanplane)
    mesh = load_camera_mesh(workdir.path / "mesh_cam.xyzC")
    mesh_aligned = align_on_sea_plane(mesh, meanplane) * baseline

    Ri = Rpl.T
    Ti = -Rpl.T @ Tpl
    RTplane = np.vstack([np.hstack([Ri, Ti]), [0, 0, 0, 1]])

    toNorm = np.array(
        [[2.0 / Iw, 0, -1, 0], [0, 2.0 / Ih, -1, 0], [0, 0, 1, 0], [0, 0, 0, 1]], dtype=float
    )
    SCALEi = 1.0 / baseline
    D = np.diag((SCALEi, SCALEi, -SCALEi, 1.0))

    P0plane = toNorm @ P0cam @ RTplane @ D
    P1plane = toNorm @ P1cam @ RTplane @ D

    K0_44 = np.eye(4)
    K0_44[:3, :3] = K0
    K1_44 = np.eye(4)
    K1_44[:3, :3] = K1
    Cam0toGrid = np.linalg.inv(D) @ np.linalg.inv(RTplane) @ np.linalg.inv(np.linalg.inv(K0_44) @ P0cam)
    Cam1toGrid = np.linalg.inv(D) @ np.linalg.inv(RTplane) @ np.linalg.inv(np.linalg.inv(K1_44) @ P1cam)

    xmin = area_center[0] - area_size_x / 2
    xmax = area_center[0] + area_size_x / 2
    ymin = area_center[1] - area_size_y / 2
    ymax = area_center[1] + area_size_y / 2
    zmax = float(np.quantile(mesh_aligned[2, :], 0.98) * 1.5)
    zmin = float(np.quantile(mesh_aligned[2, :], 0.02) * 1.5)
    if abs(zmax) > abs(zmin):
        zmin = -zmax
    else:
        zmax = -zmin

    XX, YY = np.meshgrid(np.linspace(xmin, xmax, Nx), np.linspace(ymin, ymax, Ny))
    x_spacing = XX[0, 1] - XX[0, 0]
    y_spacing = YY[1, 0] - YY[0, 0]

    kx_ab = np.array([float(i) / Nx * (2.0 * np.pi / x_spacing) for i in range(-(Nx // 2), Nx - Nx // 2)])
    ky_ab = np.array([float(i) / Ny * (2.0 * np.pi / y_spacing) for i in range(-(Ny // 2), Ny - Ny // 2)])
    KX_ab, KY_ab = np.meshgrid(kx_ab, ky_ab)

    return GridSetup(
        XX=XX, YY=YY, KX_ab=KX_ab, KY_ab=KY_ab,
        Rpl=Rpl, Tpl=Tpl,
        P0cam=P0cam, P1cam=P1cam, P0plane=P0plane, P1plane=P1plane,
        Cam0toGrid=Cam0toGrid, Cam1toGrid=Cam1toGrid,
        K0=K0, K1=K1, baseline=baseline,
        xmin=xmin, xmax=xmax, ymin=ymin, ymax=ymax, zmin=zmin, zmax=zmax,
        x_spacing=x_spacing, y_spacing=y_spacing, fps=fps, timestring=timestring,
    )
