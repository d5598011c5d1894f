"""wass-tpu-torch-gridsurface: the wassgridsurface console on the port.

  wass-tpu-torch-gridsurface WORKDIR OUTDIR --action setup --baseline B [...]
      the grid geometry from the first frame workdir and the mean plane,
      written to OUTDIR/config.mat
  wass-tpu-torch-gridsurface WORKDIR OUTDIR --action grid [...]
      every frame workdir gridded on the device into OUTDIR/gridded.nc

The options and defaults of the JAX package's wass-tpu-gridsurface
(wass_tpu/cli/gridsurface.py, after the reference's CLI,
gridding/wassgridsurface/wassgridsurface.py:596-768),
plus --device.  --mask takes an 8-bit grayscale PNG (the port's codec).
The matplotlib renders (area_grid.png, gridded.png) are not made: the
port has no plotting library; grid_img.png is written.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from wass_tpu_torch.cli.main import DEVICE_HELP

PROG = "wass-tpu-torch-gridsurface"
NO_PLOTS = "the port has no plotting library (ROADMAP.md §1 item 11)"


def _fail(msg: str) -> int:
    print(f"{PROG}: {msg}", file=sys.stderr)
    return 1


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
                        help="photo-consistency surface refinement (not ported: refused)")
    parser.add_argument("--mask", type=Path, default=None,
                        help="user grid mask: 8-bit grayscale PNG of the grid size; zero pixels are "
                             "excluded from every frame (reference --mask, wassgridsurface.py:640)")
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
    if args.refine:
        return _fail("--refine (the photo-consistency refinement, wass_tpu/grid/variational.py) is not "
                     "ported yet (ROADMAP.md §1 item 8)")
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
        print(f"(area plot skipped: {NO_PLOTS})")
        print(f"grid setup saved to {out / 'config.mat'}")
        return 0

    matfile = args.gridsetup or out / "config.mat"
    if not matfile.exists():
        return _fail(f"{matfile} not found; run --action setup first")
    setup = GridSetup.load_mat(matfile)
    cfg = GridConfig(
        algorithm=args.algorithm, subsample_percent=args.subsample,
        median_filter_size=args.medianfilter, filter_outliers=args.filter_outliers,
        force_zero_mean=args.force_zero_mean, save_images=not args.no_images,
    )
    user_mask = None
    if args.mask is not None:
        from wass_tpu_torch.io.png import read_gray

        user_mask = (read_gray(args.mask) > 0).astype(np.float32)
        if user_mask.shape != setup.XX.shape:
            return _fail(f"--mask shape {user_mask.shape} != grid {setup.XX.shape}")
    grid_sequence(wds, setup, out / "gridded.nc", cfg, user_mask=user_mask, diag_dir=out, device=device)
    print(f"(gridded.png skipped: {NO_PLOTS})")
    print(f"gridded {len(wds)} frames into {out / 'gridded.nc'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
