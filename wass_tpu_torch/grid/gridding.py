"""Per-frame point-cloud -> regular-grid surface reconstruction, on the card.

Counterpart of wass_tpu/grid/gridding.py, the wassgridsurface --action
grid equivalent (_grid_task,
gridding/wassgridsurface/wassgridsurface.py:304-523):
align the compressed camera mesh to the sea plane, quantize points into
grid cells with NREPS=10 random-subsample *median stacking*, interpolate
the holes (DCT / IDW / LinearND), optional median filter, the optional
photo-consistency refinement (--refine, grid/variational.py), and stream
the frames into the gridded.nc cube.

A frame stays on its device from the mesh upload to its Z grid: the
.xyzC decode, both plane transforms and the cell indices are float64
tensors (each 3x3 product written out in one fixed order), the median
stack, the fill, the masks and the median filter are torch ops, and the
one host read is the frame's slab for the cube.  LinearND is host scipy,
as in the JAX package.

Median stack: each repetition scatters a random subsample of the points
into the grid and the last write to a cell wins, in subsample order (the
order of XLA's CPU scatter).  CUDA leaves the winner of duplicate indices
undefined, so each cell takes the largest subsample position that hits
it (found by one sort) and gathers that point's z: the same winner on
any device, deterministic.  The median is jnp.nanmedian's linear
quantile, written out (torch.nanmedian returns the lower middle value).
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from wass_tpu_torch.device import resolve_device, to_device
from wass_tpu_torch.grid.interpolators import dct_interpolate, idw_interpolate
from wass_tpu_torch.grid.setup import GridSetup
from wass_tpu_torch.io import png
from wass_tpu_torch.io.image import CAM_IMAGE_QUALITY, encode_jpeg
from wass_tpu_torch.io.workdir import Workdir
from wass_tpu_torch.ops.morphology import median_filter


@dataclasses.dataclass(frozen=True)
class GridConfig:
    algorithm: str = "DCT"  # DCT | IDW | LinearND (wassgridsurface.py:639)
    nreps: int = 10
    subsample_percent: float = 100.0
    median_filter_size: int = 0
    dct_nfreqs: int = 150
    dct_iters: int = 500
    dct_alpha: float = 8e-7
    seed: int = 0
    # Local-plane outlier voting before gridding (filter_mesh_outliers,
    # wass_utils.py:72-163; its call-site is commented out in the
    # reference, wassgridsurface.py:453-454 — off by default here too).
    filter_outliers: bool = False
    outlier_threshold: float = 0.2
    # Chunked per-point zero-mean rewrite after gridding
    # (wassgridsurface.py:543-576).
    force_zero_mean: bool = False
    # Which camera's undistorted frame is pushed into the cube
    # (wassgridsurface.py:494, image_id_to_save).
    image_id_to_save: int = 0
    save_images: bool = True
    # Photo-consistency refinement of the gridded surface (--refine;
    # grid/variational.py, the reference's experimental
    # TFVariationalRefinement, call-site commented out there; off by
    # default here too).
    variational: bool = False


def load_mesh(path, device) -> torch.Tensor:
    """mesh_cam.xyzC decoded to camera-frame points (3, N) float64 on
    device: the host reads the file, the device decodes it (the port's
    io/xyzc.load_camera_mesh, with Rinv @ mesh written out)."""
    with open(path, "rb") as f:
        npts = struct.unpack("<I", f.read(4))[0]
        limits = np.array(struct.unpack("<6d", f.read(48)))
        Rinv = np.frombuffer(f.read(72), dtype="<f8").reshape(3, 3)
        Tinv = np.frombuffer(f.read(24), dtype="<f8").reshape(3, 1)
        raw = np.fromfile(f, dtype="<i2", count=3 * npts).reshape(npts, 3)  # the u16 words
    data = to_device(torch.from_numpy(raw), device).to(torch.int32) & 0xFFFF
    lim = torch.as_tensor(limits, dtype=torch.float64, device=device)
    mesh = data.T.double() / lim[0:3, None] + lim[3:6, None]
    return _affine(Rinv, Tinv, mesh)


def _affine(R: np.ndarray, T: np.ndarray, P: torch.Tensor) -> torch.Tensor:
    """R @ P + T for a (3, 3) R and (3, N) float64 P, each row summed as
    ((r0 x + r1 y) + r2 z) + t, the same bits on every device."""
    R = np.asarray(R, np.float64).tolist()
    T = np.asarray(T, np.float64).reshape(3).tolist()
    x, y, z = P[0], P[1], P[2]
    return torch.stack([((R[i][0] * x + R[i][1] * y) + R[i][2] * z) + T[i] for i in range(3)])


def align_mesh(mesh: torch.Tensor, setup: GridSetup) -> torch.Tensor:
    """Camera mesh (3, N) -> sea-plane frame, z up, in meters."""
    out = _affine(setup.Rpl, setup.Tpl, mesh)
    out = torch.cat([out[:2], -out[2:]])
    return out * float(setup.baseline)


def bin_points(mesh_aligned: torch.Tensor, setup: GridSetup) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nearest grid cell of each aligned point: (px, py) int64 clipped to
    the grid, and the in-grid mask (wass_tpu/grid/gridding.py:108-113)."""
    H, W = setup.XX.shape
    sx = setup.xmax - setup.xmin
    sy = setup.ymax - setup.ymin
    px = torch.floor((mesh_aligned[0] - setup.xmin) / sx * (W - 1) + 0.5).to(torch.int64)
    py = torch.floor((mesh_aligned[1] - setup.ymin) / sy * (H - 1) + 0.5).to(torch.int64)
    good = (px >= 0) & (px < W) & (py >= 0) & (py < H)
    return px.clamp(0, W - 1), py.clamp(0, H - 1), good


def median_draws(npts: int, nreps: int, n_use: int, seed: int, device) -> torch.Tensor:
    """(nreps, n_use) subsamples, each the head of a random permutation of
    the points, from a torch.Generator seeded with `seed` on `device`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.stack([torch.randperm(npts, generator=gen, device=device)[:n_use] for _ in range(nreps)])


def nanmedian(ZZ: torch.Tensor) -> torch.Tensor:
    """jnp.nanmedian over axis 0: the linear quantile at 0.5 of the
    non-NaN values (NaN where there is none)."""
    a = torch.sort(torch.where(torch.isnan(ZZ), torch.nan, ZZ), dim=0).values  # NaN sorts last
    counts = (~torch.isnan(a)).sum(0).to(ZZ.dtype)
    q = 0.5 * (counts - 1)
    low, high = torch.floor(q), torch.ceil(q)
    hw = q - low
    lw = 1 - hw
    low = torch.maximum(torch.zeros_like(low), torch.minimum(low, counts - 1)).long()
    high = torch.maximum(torch.zeros_like(high), torch.minimum(high, counts - 1)).long()
    lo = a.gather(0, low[None])[0]
    hi = a.gather(0, high[None])[0]
    return lo * lw + hi * hw


def _median_stack(pts_x, pts_y, pts_z, good, shape, nreps: int, n_use: int, perms: Optional[torch.Tensor] = None,
                  seed: int = 0) -> torch.Tensor:
    """(H, W) nanmedian of nreps last-write-wins scatters of a random
    subsample (wassgridsurface.py:330-346).  perms: the (nreps, n_use)
    subsamples; median_draws(seed) when None."""
    H, W = shape
    HW = H * W
    dev = pts_z.device
    flat = torch.where(good, pts_y * W + pts_x, HW)  # invalid points go to a cell off the grid
    if perms is None:
        perms = median_draws(pts_z.shape[0], nreps, n_use, seed, dev)
    perms = perms.to(dev, torch.int64)
    if perms.shape[1] == 0:  # no point (a failed frame's empty mesh): every cell NaN
        return torch.full((H, W), torch.nan, device=dev)
    # One sort of (draw, cell, position) keys: each (draw, cell) run ends
    # at its largest position, the write that wins.  Only run ends are
    # scattered to their cell (the rest to a dump slot), so no two writes
    # meet: the same winner on any device.  (scatter_reduce's amax gives
    # the same winners, far slower on the card.)
    n_slots = nreps * (HW + 1)
    cells = flat[perms] + (HW + 1) * torch.arange(nreps, device=dev)[:, None]
    key = torch.sort((cells * n_use + torch.arange(n_use, device=dev)).reshape(-1)).values
    cell = key // n_use
    run_end = torch.ones_like(key, dtype=torch.bool)
    run_end[:-1] = cell[1:] != cell[:-1]
    last = torch.full((n_slots + 1,), -1, dtype=torch.int64, device=dev)
    last.scatter_(0, torch.where(run_end, cell, n_slots), key % n_use)
    last = last[:n_slots].view(nreps, HW + 1)[:, :HW]
    z = pts_z[perms.gather(1, last.clamp_min(0))]
    ZZ = torch.where(last >= 0, z, torch.nan).view(nreps, H, W)
    return nanmedian(ZZ)


def _linear_nd(mesh_aligned: torch.Tensor, good: torch.Tensor, setup: GridSetup, cfg: GridConfig):
    """Delaunay linear interpolation of the (subsampled) scattered points
    (wassgridsurface.py:437-480), host scipy as in the JAX package."""
    from scipy.interpolate import LinearNDInterpolator

    H, W = setup.XX.shape
    mesh = mesh_aligned.cpu().numpy()
    sel = np.flatnonzero(good.cpu().numpy())
    rng = np.random.default_rng(cfg.seed)
    rng.shuffle(sel)
    sel = sel[: max(int(sel.size * cfg.subsample_percent / 100.0), 4)]
    interp = LinearNDInterpolator(mesh[:2, sel].T, mesh[2, sel])
    Zi = interp(np.c_[setup.XX.ravel(), setup.YY.ravel()]).reshape(H, W)
    mask = np.isfinite(Zi).astype(np.float32)
    return torch.from_numpy(np.nan_to_num(Zi)), torch.from_numpy(mask)  # Z stays float64, as in the JAX package


def grid_frame(
    workdir: Workdir,
    setup: GridSetup,
    cfg: GridConfig = GridConfig(),
    user_mask=None,
    device="cuda",
    perms: Optional[torch.Tensor] = None,
    x0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grid one frame: (Z, mask) (H, W) tensors on device, Z in meters on
    the setup's XY grid, NaN outside the mask; float32, but LinearND's Z
    is float64 unless median-filtered (as in the JAX package).

    user_mask: optional (H, W) {0,1} grid mask multiplied into the
    interpolation mask (reference --mask flag, wassgridsurface.py:281-286,
    355-363).  perms and x0: the median stack's subsamples and the DCT
    fit's initial coefficients (drawn from cfg.seed on the device when
    None)."""
    dev = resolve_device(device)
    mesh_aligned = align_mesh(load_mesh(workdir.path / "mesh_cam.xyzC", dev), setup)

    if cfg.filter_outliers and mesh_aligned.shape[1]:
        from wass_tpu_torch.grid.outliers import filter_mesh_outliers

        mesh_aligned = filter_mesh_outliers(mesh_aligned, cfg.outlier_threshold)

    H, W = setup.XX.shape
    px, py, good = bin_points(mesh_aligned, setup)
    n_use = max(1, int(px.shape[0] * cfg.subsample_percent // 100))
    Z = _median_stack(px, py, mesh_aligned[2].float(), good, (H, W), cfg.nreps, n_use, perms, cfg.seed)

    algorithm = cfg.algorithm.upper()
    if algorithm == "IDW":
        Zi, mask = idw_interpolate(Z)
    elif algorithm == "LINEARND":
        Zi, mask = (t.to(dev) for t in _linear_nd(mesh_aligned, good, setup, cfg))
    else:
        Zi, mask = dct_interpolate(Z, nfreqs=cfg.dct_nfreqs, max_iters=cfg.dct_iters, alpha=cfg.dct_alpha,
                                   seed=cfg.seed, x0=x0)

    if user_mask is not None:
        mask = mask * torch.as_tensor(user_mask, dtype=torch.float32).to(dev)
    Zi = torch.where(mask > 0, Zi, torch.nan)
    if cfg.median_filter_size >= 3:
        Zi = median_filter(torch.nan_to_num(Zi, nan=0.0).float(), cfg.median_filter_size)
        Zi = torch.where(mask > 0, Zi, torch.nan)
    if cfg.variational:
        # Photo-consistency polish against the undistorted frames.
        from wass_tpu_torch.grid.variational import variational_refine

        P0cam, P1cam = workdir.load_projection_matrices()
        Zi = variational_refine(
            Zi.float(), workdir.load_undistorted(0), workdir.load_undistorted(1), P0cam, P1cam, setup.Rpl, setup.Tpl,
            setup.XX, setup.YY, setup.baseline, (mask > 0).float(),
        )
    return Zi, mask


@dataclasses.dataclass
class GridStats:
    """Streaming summary of a gridded sequence (no per-frame Z grid is
    kept: an hour of 20 Hz frames at 512x512 would be ~38 GB)."""

    n_frames: int = 0
    zmin: float = float("nan")
    zmax: float = float("nan")
    zmean: Optional[np.ndarray] = None  # (H, W) temporal mean (meters)


def grid_sequence(
    workdirs: Sequence[Workdir],
    setup: GridSetup,
    out_path,
    cfg: GridConfig = GridConfig(),
    fps: Optional[float] = None,
    user_mask: Optional[np.ndarray] = None,
    diag_dir=None,
    device="cuda",
) -> GridStats:
    """Grid all frames into the gridded.nc cube.

    Streaming: each frame is gridded on the device, its slab read once
    and written at its offset in the cube, and dropped; the running z
    statistics (one (H, W) float64 sum grid) stay on the device.  user_mask
    (reference --mask) is applied per frame and written into maskZ;
    diag_dir, when set, receives frame 0's grid_img.png
    (wassgridsurface.py:364-375)."""
    from wass_tpu_torch.grid.netcdf import NetCDFWriter

    dev = resolve_device(device)
    H, W = setup.XX.shape
    fps = fps if fps is not None else (setup.fps or 1.0)
    writer = NetCDFWriter(out_path, M=H, N=W, count=len(workdirs))
    try:
        writer.scale = setup.baseline
        writer.set_grids(setup.XX * 1000.0, setup.YY * 1000.0)
        writer.set_kxky(setup.KX_ab, setup.KY_ab)
        writer.set_intrinsics(
            setup.K0, setup.K1, np.zeros(5), np.zeros(5),
            setup.P0plane, setup.P1plane, setup.P0cam[:3], setup.P1cam[:3],
            setup.Cam0toGrid, setup.Cam1toGrid,
        )
        writer.add_meta_attribute("generator", "wass_tpu")
        writer.add_meta_attribute("baseline", setup.baseline)
        writer.add_meta_attribute("fps", fps)
        writer.set_mask(
            np.ones((H, W), np.float32) if user_mask is None
            else np.asarray(user_mask, np.float32)
        )

        stats = GridStats()
        zsum = torch.zeros((H, W), dtype=torch.float64, device=dev)
        zmin = torch.tensor(float("inf"), device=dev)
        zmax = torch.tensor(float("-inf"), device=dev)
        for i, wd in enumerate(workdirs):
            Z, _ = grid_frame(wd, setup, cfg, user_mask=user_mask, device=dev)
            frame_idx = int(str(wd.path.name)[:-3]) if str(wd.path.name).endswith("_wd") else i
            image = imagemask = None
            if cfg.save_images:
                image, imagemask, dims = _load_frame_jpeg(wd, cfg.image_id_to_save)
                if dims is not None:
                    writer.add_meta_attribute("image_width", dims[1])
                    writer.add_meta_attribute("image_height", dims[0])
            writer.push_Z((Z * 1000.0).cpu().numpy(), time=i / fps, workdir=frame_idx,
                          image=image, imagemask=imagemask)
            if i == 0 and diag_dir is not None:
                _save_grid_diagnostics(Z, diag_dir)
            finite = ~torch.isnan(Z)
            zsum += torch.where(finite, Z, 0.0).double()
            zmin = torch.minimum(zmin, torch.where(finite, Z, torch.inf).min())
            zmax = torch.maximum(zmax, torch.where(finite, Z, -torch.inf).max())
            stats.n_frames += 1

        # zmin/zmax/zmean provenance attributes (wassgridsurface.py:528-549).
        if stats.n_frames:
            stats.zmin, stats.zmax = float(zmin), float(zmax)
            stats.zmean = (zsum / stats.n_frames).cpu().numpy()
            if cfg.force_zero_mean:
                writer.add_meta_attribute("zmin", stats.zmin)
                writer.add_meta_attribute("zmax", -stats.zmin)
                writer.add_meta_attribute("zmean", 0.0)
            else:
                writer.add_meta_attribute("zmin", stats.zmin)
                writer.add_meta_attribute("zmax", stats.zmax)
    finally:
        writer.close()

    if cfg.force_zero_mean and stats.n_frames:
        _force_zero_mean_chunked(out_path, (stats.zmean * 1000.0).astype(np.float32))
    return stats


GRID_FIGSIZE, GRID_DPI = (8, 8), 100  # gridded.png: the JAX figure's inches, matplotlib's default dpi


def grid_figure(Z: np.ndarray):
    """gridded.png's figure (wassgridsurface.py:364-375): the frame's Z as
    an image over its [nanmin, nanmax] in viridis, NaN cells white, row 0
    at the top, equal aspect, with a colorbar.  Returns its axes."""
    from wass_tpu_torch.utils import plotting as pl

    zmin, zmax = float(np.nanmin(Z)), float(np.nanmax(Z))
    fig = pl.Figure(*GRID_FIGSIZE, GRID_DPI)
    box, bar = pl.split_colorbar(fig.subplot_box())
    H, W = Z.shape
    ax = pl.Axes(fig, pl.fit_aspect(box, H, W), (-0.5, W - 0.5), (-0.5, H - 0.5), yinvert=True)
    ax.image(pl.colormap(Z, zmin, zmax))
    ax.decorate()
    pl.colorbar(fig, bar, zmin, zmax)
    return ax


def _save_grid_diagnostics(Z: torch.Tensor, diag_dir) -> None:
    """Frame 0's grid_img.png (normalized grayscale, wassgridsurface.py:364-375)
    through the port's PNG codec, and gridded.png drawn with OpenCV from
    the fetched Z (a failure of the figure is printed, not raised)."""
    diag = Path(diag_dir)
    diag.mkdir(parents=True, exist_ok=True)
    finite = ~torch.isnan(Z)
    if not bool(finite.any()):
        return
    zmin = torch.where(finite, Z, torch.inf).min()
    zmax = torch.where(finite, Z, -torch.inf).max()
    img = (Z - zmin) / torch.clamp_min(zmax - zmin, 1e-12) * 255.0
    png.write_gray(diag / "grid_img.png", torch.nan_to_num(img, nan=0.0).to(torch.uint8).cpu().numpy())
    try:
        grid_figure(Z.cpu().numpy()).fig.save(diag / "gridded.png")
    except Exception as e:  # diagnostics must never fail the stage
        print(f"(gridded.png skipped: {e})")


def _load_frame_jpeg(wd: Workdir, cam: int):
    """The undistorted frame JPEG-encoded at quality 90 for the cube's
    cam0images variable, as the JAX package's native encoder does (the
    bytes differ by encoder, the decoded images agree), with its (H, W),
    plus the raw mask bytes when undistorted/maskN.png exists
    (wassgridsurface.py:494-513).  (None, None, None) when the frame
    cannot be read, as in the JAX package."""
    try:
        img = wd.load_undistorted(cam)
        maskfile = wd.path / "undistorted" / f"mask{cam}.png"
        imagemask = maskfile.read_bytes() if maskfile.exists() else None
        return encode_jpeg(img, CAM_IMAGE_QUALITY), imagemask, img.shape
    except (OSError, ValueError):
        return None, None, None


def _force_zero_mean_chunked(ncfile, mean_mm: np.ndarray, block: int = 64) -> None:
    """Per-point temporal zero-mean as an in-place rewrite of the
    contiguous Z slab, `block` frames at a time (wassgridsurface.py:543-576:
    never the whole cube)."""
    from wass_tpu_torch.grid.netcdf import NetCDFReader

    with NetCDFReader(ncfile) as cube:
        z = cube.Z
        addr, shape = z.data_addr, z.shape
    meanT = np.asarray(mean_mm, np.float32).T  # the cube stores (count, N=X, M=Y) = Z.T per frame
    for t0 in range(0, shape[0], block):
        n = min(block, shape[0] - t0)
        mm = np.memmap(ncfile, dtype="<f4", mode="r+", offset=addr + 4 * t0 * shape[1] * shape[2],
                       shape=(n,) + tuple(shape[1:]))
        mm -= meanT
        mm.flush()
        del mm
