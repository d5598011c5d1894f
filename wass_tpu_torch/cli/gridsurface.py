"""wass-tpu-torch-gridsurface: the wassgridsurface console on the port.

  wass-tpu-torch-gridsurface WORKDIR OUTDIR --action setup --baseline B [...]
      the grid geometry from the first frame workdir and the mean plane,
      written to OUTDIR/config.mat
  wass-tpu-torch-gridsurface WORKDIR OUTDIR --action grid [...]
      every frame workdir gridded on the device into OUTDIR/gridded.nc

The options and defaults of the JAX package's wass-tpu-gridsurface
(wass_tpu/cli/gridsurface.py, after the reference's CLI,
gridding/wassgridsurface/wassgridsurface.py:596-768),
plus --device.  --mask takes any image OpenCV decodes (nonzero pixels of
its first channel kept, as the JAX console reads imageio's array).
setup writes area_grid.png and grid writes gridded.png and grid_img.png,
as the JAX console does; the two figures are drawn with OpenCV
(utils/plotting.py), with matplotlib's data, limits and marks but not its
pixels.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from wass_tpu_torch.cli.main import DEVICE_HELP

PROG = "wass-tpu-torch-gridsurface"
AREA_FIGSIZE, AREA_DPI = (12, 12), 100  # the JAX figure's inches and savefig dpi
AREA_STRIDE = 50  # every 50th point of the mesh


def _fail(msg: str) -> int:
    print(f"{PROG}: {msg}", file=sys.stderr)
    return 1


def area_figure(ma: np.ndarray, setup, title: str):
    """area_grid.png's figure (wassgridsurface.py:176-190): every 50th
    point of the aligned mesh ma (3, N, scaled by the baseline) coloured by
    z over [zmin, zmax] in viridis, later points over earlier ones, the y
    axis inverted, equal axes, a colorbar and the grid's rectangle in
    black.  Returns its axes."""
    from wass_tpu_torch.utils import plotting as pl

    x, y, z = (np.asarray(v, np.float64) for v in ma[:, ::AREA_STRIDE])
    ok = np.isfinite(x) & np.isfinite(y) & np.isfinite(z)
    x, y, z = x[ok], y[ok], z[ok]
    rx = [setup.xmin, setup.xmax, setup.xmax, setup.xmin, setup.xmin]
    ry = [setup.ymin, setup.ymin, setup.ymax, setup.ymax, setup.ymin]
    fig = pl.Figure(*AREA_FIGSIZE, AREA_DPI)
    box, bar = pl.split_colorbar(fig.subplot_box())
    xlim = pl.data_limits(min(np.min(x, initial=np.inf), setup.xmin), max(np.max(x, initial=-np.inf), setup.xmax))
    ylim = pl.data_limits(min(np.min(y, initial=np.inf), setup.ymin), max(np.max(y, initial=-np.inf), setup.ymax))
    xlim, ylim = pl.equal_limits(box, xlim, ylim)
    ax = pl.Axes(fig, box, xlim, ylim, yinvert=True)
    ax.grid()
    ax.scatter(x, y, pl.colormap(z, setup.zmin, setup.zmax))
    ax.line(rx, ry, pl.BLACK, 2.0)
    ax.decorate(title)
    pl.colorbar(fig, bar, setup.zmin, setup.zmax)
    return ax


def _save_area_plot(wd, setup, meanplane, out: Path) -> None:
    """area_grid.png: the point cloud and the grid's footprint; a failure
    is printed and does not fail the stage (as in the JAX console)."""
    try:
        from wass_tpu_torch.grid.setup import align_on_sea_plane
        from wass_tpu_torch.io.xyzc import load_camera_mesh

        mesh = load_camera_mesh(wd.path / "mesh_cam.xyzC")
        ma = align_on_sea_plane(mesh, meanplane) * setup.baseline
        area_figure(ma, setup, f"WASS point cloud {wd.path}").fig.save(out / "area_grid.png")
    except Exception as e:  # diagnostics must never fail the stage
        print(f"(area plot skipped: {e})")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog=PROG, description=__doc__.splitlines()[0])
    parser.add_argument("workdir", type=Path)
    parser.add_argument("outdir", type=Path)
    parser.add_argument("--action", choices=("setup", "grid"), required=True)
    parser.add_argument("--baseline", type=float, default=None, help="camera baseline in meters")
    parser.add_argument("--gridsetup", type=Path, default=None, help="config.mat from a previous setup")
    parser.add_argument("--area_center", default="0,0")
    parser.add_argument("--area_size", type=float, default=50.0)
    parser.add_argument("-N", "--grid_size", type=int, default=256)
    parser.add_argument("--fps", type=float, default=1.0)
    parser.add_argument("--algorithm", "--ia", choices=("DCT", "IDW", "LinearND"), default="DCT")
    parser.add_argument("--subsample", type=float, default=100.0, help="point subsample percentage")
    parser.add_argument("-mf", "--medianfilter", type=int, default=0)
    parser.add_argument("--filter-outliers", action="store_true",
                        help="local-plane outlier voting before gridding (filter_mesh_outliers)")
    parser.add_argument("--force-zero-mean", action="store_true",
                        help="chunked per-point temporal zero-mean rewrite after gridding")
    parser.add_argument("--no-images", action="store_true", help="skip pushing the cam frames into the cube")
    parser.add_argument("--refine", action="store_true",
                        help="photo-consistency surface refinement (experimental; the reference's "
                             "TFVariationalRefinement)")
    parser.add_argument("--mask", type=Path, default=None,
                        help="user grid mask: an image of the grid size; zero pixels (of its first channel) "
                             "are excluded from every frame (reference --mask, wassgridsurface.py:640)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"), help=DEVICE_HELP)
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--area_center" in argv[:-1]:  # "-5,-20" is a value here (click takes it), not an option
        i = argv.index("--area_center")
        argv[i:i + 2] = [f"--area_center={argv[i + 1]}"]
    args = parser.parse_args(argv)

    from wass_tpu_torch.device import resolve_device
    from wass_tpu_torch.grid.gridding import GridConfig, grid_sequence
    from wass_tpu_torch.grid.setup import GridSetup, grid_setup
    from wass_tpu_torch.io.workdir import frame_workdirs

    if not args.workdir.is_dir():
        parser.error(f"no such directory: {args.workdir}")
    device = resolve_device(args.device)
    if args.mask is not None and not args.mask.exists():
        parser.error(f"no such file: {args.mask}")
    out = args.outdir
    out.mkdir(parents=True, exist_ok=True)
    wds = frame_workdirs(args.workdir)
    if not wds:
        return _fail(f"no *_wd frame directories under {args.workdir}")

    # Mean plane over the sequence (wassgridsurface.py:664-678).
    planes_file = args.workdir / "output" / "planes.txt"
    if planes_file.exists():
        meanplane = np.nanmean(np.loadtxt(planes_file, ndmin=2), axis=0)
    else:
        meanplane = wds[0].load_plane()

    if args.action == "setup":
        if args.baseline is None:
            return _fail("--baseline is required for setup")
        cx, cy = (float(v) for v in args.area_center.split(","))
        setup = grid_setup(
            wds[0], meanplane, args.baseline,
            area_center=(cx, cy), area_size_x=args.area_size, area_size_y=args.area_size,
            Nx=args.grid_size, Ny=args.grid_size, fps=args.fps,
        )
        setup.save_mat(out / "config.mat")
        _save_area_plot(wds[0], setup, meanplane, out)
        print(f"grid setup saved to {out / 'config.mat'}")
        return 0

    matfile = args.gridsetup or out / "config.mat"
    if not matfile.exists():
        return _fail(f"{matfile} not found; run --action setup first")
    setup = GridSetup.load_mat(matfile)
    cfg = GridConfig(
        algorithm=args.algorithm, subsample_percent=args.subsample,
        median_filter_size=args.medianfilter, filter_outliers=args.filter_outliers,
        force_zero_mean=args.force_zero_mean, save_images=not args.no_images, variational=args.refine,
    )
    user_mask = None
    if args.mask is not None:
        from wass_tpu_torch.io.image import read_image

        try:
            user_mask = (read_image(args.mask) > 0).astype(np.float32)
        except ValueError as e:
            return _fail(f"--mask: {e}")
        if user_mask.ndim == 3:
            user_mask = user_mask[..., 0]
        if user_mask.shape != setup.XX.shape:
            return _fail(f"--mask shape {user_mask.shape} != grid {setup.XX.shape}")
    grid_sequence(wds, setup, out / "gridded.nc", cfg, user_mask=user_mask, diag_dir=out, device=device)
    print(f"gridded {len(wds)} frames into {out / 'gridded.nc'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
