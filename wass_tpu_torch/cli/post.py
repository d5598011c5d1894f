"""wass-tpu-torch-post: the wasspost console on the port.

  wass-tpu-torch-post COMMAND NCFILE [options] [--device cuda|cpu]

The commands, options and defaults of the JAX package's wass-tpu-post
(wass_tpu/cli/post.py, after the reference's postproc/wasspost/wasspost.py):
info, filter, spatial_lowpass, spectrum, spectrum3d, setfps, zeromean,
clip, visibilitymap, renamevar, radiance, bgimage, radiance_threshold and
polarimetric_setup (dashes or underscores), plus --device.  Each writes
the dataset names, dtypes and attributes of the JAX command.

Cubes are read and edited by the port's own HDF5 code (io/hdf5.py; the
GPU host has no h5py), streamed under WASS_POST_MEMORY_MB (default 512).
A command that writes to a cube of another layout (the JAX package's
h5py cube: chunked, symbol-table groups) first rewrites it in the port's
layout and says so; `info`, `spectrum` and `spectrum3d` read such a cube
as it is.  `radiance` decodes the JPEG frames of `cam0images` (the JAX
package's cubes and the port's) and the PNG frames of the port's earlier
cubes; `polarimetric_setup` reads the Stokes TIFFs that prepare writes
with save_stokes.  `spectrum` draws its PNG plot with OpenCV
(post/plotting.py): the JAX figure's file, data and marks, not
matplotlib's pixels.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
from pathlib import Path

import numpy as np

from wass_tpu_torch.cli.main import DEVICE_HELP

PROG = "wass-tpu-torch-post"


class CommandError(Exception):
    """A command's refusal, printed with the program's name (exit code 1)."""


def _read(ncfile):
    from wass_tpu_torch.io import hdf5

    return hdf5.H5File(ncfile)


@contextlib.contextmanager
def _edit(ncfile):
    """The cube opened for writing; a cube of another layout is first
    rewritten in the port's (a copy streamed under the memory budget)."""
    from wass_tpu_torch.io import hdf5
    from wass_tpu_torch.post.ooc import memory_budget_bytes

    with hdf5.H5File(ncfile) as f:
        editable = f.editable
    if not editable:
        tmp = Path(f"{ncfile}.port-layout.tmp")
        hdf5.copy_to_port_layout(ncfile, tmp, memory_budget_bytes())
        os.replace(tmp, ncfile)
        print(f"converted {ncfile} to the port's layout (contiguous datasets, compact links) before writing")
    with hdf5.H5File(ncfile, "r+") as f:
        yield f


def _du(f) -> float:
    XX = f["X_grid"][...] / 1000.0
    return abs(XX[1, 0] - XX[0, 0]) or abs(XX[0, 1] - XX[0, 0])


def cmd_info(a):
    from wass_tpu_torch.io import hdf5

    with _read(a.ncfile) as f:
        print(f"Variables in {a.ncfile}:")

        def show(name, obj):
            if isinstance(obj, hdf5.H5Dataset):
                print(f"  {name}: shape={obj.shape} dtype={obj.dtype}")

        f.visititems(show)
        if "meta" in f:
            for k, v in f["meta"].attrs.items():  # h5py's order
                print(f"  meta.{k} = {v}")


def cmd_filter(a):
    from wass_tpu_torch.post.filters import temporal_butterworth
    from wass_tpu_torch.post.ooc import apply_timewise

    with _read(a.ncfile) as f:
        if f[a.filter_variable].shape[0] <= 10:  # the reference's contract (wasspost.py:171-173)
            raise CommandError("Dataset too short. I need more than 10 frames for lowpass filtering")
    with _edit(a.ncfile) as f:
        fps = float(f["meta"].attrs.get("fps", 1.0))
        name = a.filter_variable if a.overwrite else a.filter_variable + "_filtered"
        apply_timewise(f, a.filter_variable, name,
                       lambda blk: temporal_butterworth(blk, fps=fps, cutoff_hz=a.cutoff, kind=a.kind).astype(np.float32),
                       dtype="f4")
        f[name].attrs["frequency_filter_cutoff"] = a.cutoff
    print(f"wrote {name}")


def cmd_spatial_lowpass(a):
    from wass_tpu_torch.post.filters import spatial_butterworth_lowpass
    from wass_tpu_torch.post.ooc import apply_framewise

    with _edit(a.ncfile) as f:
        du = _du(f)
        name = a.filter_variable + "_slp"
        apply_framewise(f, a.filter_variable, name,
                        lambda blk: spatial_butterworth_lowpass(blk, du=du, cutoff=a.cutoff_in_hz,
                                                                device=a.device).astype(np.float32),
                        dtype="f4")
    print(f"wrote {name}")


def cmd_spectrum(a):
    from wass_tpu_torch.post.spectra import compute_spectrum, spectrum_stats

    with _read(a.ncfile) as f:
        fps = float(f["meta"].attrs.get("fps", 1.0))
        # The dataset itself: compute_spectrum reads only the centre patch.
        fr, S, _ = compute_spectrum(f[a.variable], dt=1.0 / fps, nperseg=a.nperseg, rangespan=a.rangespan,
                                    scale=1e-3, device=a.device)  # mm -> m
    st = spectrum_stats(fr, S)
    print(f"Hm0  = {st.hm0:.3f} m")
    print(f"Tm01 = {st.tm01:.3f} s")
    print(f"Tp   = {st.tp:.3f} s (fp = {st.fp:.4f} Hz)")
    out = Path(a.ncfile).with_suffix(".spectrum.csv")
    np.savetxt(out, np.c_[fr, S], delimiter=";", header="f_Hz;S_m2_per_Hz")
    print(f"spectrum saved to {out}")
    try:
        from wass_tpu_torch.post.plotting import plot_spectrum

        png = Path(a.ncfile).with_suffix(".spectrum.png")
        plot_spectrum(fr, S, png)
        print(f"plot saved to {png}")
    except Exception as e:  # a diagnostic plot never fails the command
        print(f"(plot skipped: {e})")


def cmd_spectrum3d(a):
    from wass_tpu_torch.post.spectra import compute_3d_spectrum

    with _read(a.ncfile) as f:
        fps = float(f["meta"].attrs.get("fps", 1.0))
        # One Welch time segment read at a time.
        S, KX, KY, fr = compute_3d_spectrum(f["Z"], du=_du(f), dt=1.0 / fps, segments=a.segments, datascale=1e-3,
                                            device=a.device)
    out = Path(a.ncfile).with_suffix(".spectrum3d.npz")
    np.savez_compressed(out, S=S, KX=KX, KY=KY, f=fr)
    print(f"3D spectrum saved to {out}")


def cmd_setfps(a):
    with _edit(a.ncfile) as f:
        f["meta"].attrs["fps"] = a.fps
        if "time" in f and "count" in f:
            f["time"][...] = np.arange(f["count"].shape[0]) / a.fps
    print(f"fps set to {a.fps}")


def cmd_zeromean(a):
    from wass_tpu_torch.post.ooc import apply_framewise, streaming_time_mean

    with _edit(a.ncfile) as f:
        mean = streaming_time_mean(f[a.variable]).astype(np.float32)
        apply_framewise(f, a.variable, a.variable, lambda blk: blk - mean[None])
    print("per-point temporal mean removed")


def cmd_clip(a):
    from wass_tpu_torch.post.ooc import apply_framewise

    with _edit(a.ncfile) as f:
        apply_framewise(f, a.variable, a.variable, lambda blk: np.clip(blk, a.zmin, a.zmax))
    print(f"clipped {a.variable} to [{a.zmin}, {a.zmax}]")


def cmd_visibilitymap(a):
    from wass_tpu_torch.io import png
    from wass_tpu_torch.post.geometry import compute_visibility_batch
    from wass_tpu_torch.post.ooc import iter_time_slabs

    with _edit(a.ncfile) as f:
        Z = f["Z"]
        N = Z.shape[0] if a.numframes < 0 else min(a.numframes, Z.shape[0])
        XX = f["X_grid"][...] / 1000.0
        YY = f["Y_grid"][...] / 1000.0
        dx = abs(XX[0, 1] - XX[0, 0]) or abs(XX[1, 0] - XX[0, 0])
        C = f["meta"][f"Cam{a.cam}toGrid"][...] @ np.array([0.0, 0, 0, 1])
        C = C[:3] / C[3]
        occ_name, inc_name = f"occlusion_cam{a.cam}", f"incident_angles_cam{a.cam}"
        for name in (occ_name, inc_name):
            if name in f:
                del f[name]
        occ_ds = f.create_dataset(occ_name, Z.shape, "u1")
        inc_ds = f.create_dataset(inc_name, Z.shape, "f4")
        total_occ = 0
        # Slabs sized as the JAX console sizes them (8 bytes a cell).
        for ts in iter_time_slabs((N,) + Z.shape[1:], 8):
            zz_slab = np.asarray(Z[ts], np.float64) / 1000.0
            occ_b, inc_b = compute_visibility_batch(zz_slab, XX, YY, C, dx, device=a.device)
            occ_ds[ts] = occ_b
            inc_ds[ts] = inc_b
            total_occ += int(occ_b.sum())
            if a.outputdir is not None:
                Path(a.outputdir).mkdir(parents=True, exist_ok=True)
                for k in range(occ_b.shape[0]):
                    png.write_gray(Path(a.outputdir) / f"{ts.start + k:08d}_occlusion_mask_cam{a.cam}.png",
                                   occ_b[k] * np.uint8(255))
        denom = N * Z.shape[1] * Z.shape[2]
    print(f"wrote {occ_name} + {inc_name} over {N} frames ({100.0 * total_occ / max(denom, 1):.1f}% occluded)")


def cmd_renamevar(a):
    with _edit(a.ncfile) as f:
        f.move(a.srcvar, a.dstvar)
    print(f"renamed {a.srcvar} -> {a.dstvar}")


def cmd_radiance(a):
    from wass_tpu_torch.io.image import decode_gray
    from wass_tpu_torch.io.workdir import frame_workdirs
    from wass_tpu_torch.post.radiance import radiance_frame

    with _edit(a.ncfile) as f:
        Pplane = f["meta"][f"P{a.cam}plane"][...]
        XX = f["X_grid"][...] / 1000.0
        YY = f["Y_grid"][...] / 1000.0
        Z = f[a.zvariable]
        N = a.numframes if a.numframes > 0 else Z.shape[0]
        name = f"radiance_cam{a.cam}"
        if name in f:
            del f[name]
        out = f.create_dataset(name, (N,) + Z.shape[1:], "f4")
        wds = frame_workdirs(a.wassdir) if a.wassdir else None
        for i in range(N):
            if wds is not None:
                img = wds[i].load_undistorted(a.cam)
            else:
                img = decode_gray(f["cam0images"][i].tobytes()).astype(np.float32)  # JPEG or PNG
            out[i] = radiance_frame(img, Z[i] / 1000.0, XX, YY, Pplane, device=a.device)
    print(f"wrote radiance_cam{a.cam} ({N} frames)")


def cmd_bgimage(a):
    from wass_tpu_torch.post.ooc import apply_timewise
    from wass_tpu_torch.post.radiance import bg_radiance

    with _edit(a.ncfile) as f:
        name = f"radiance_bgimage_cam{a.cam}"
        apply_timewise(f, f"radiance_cam{a.cam}", name,
                       lambda blk: bg_radiance(blk, a.filtersize).astype(np.float32), dtype="f4")
    print(f"wrote {name}")


def cmd_radiance_threshold(a):
    from wass_tpu_torch.post.ooc import iter_time_slabs
    from wass_tpu_torch.post.radiance import radiance_threshold

    with _edit(a.ncfile) as f:
        rad = f[f"radiance_cam{a.cam}"]
        bg = f[f"radiance_bgimage_cam{a.cam}"]
        name = f"radiance_thresholded_cam{a.cam}"
        if name in f:
            del f[name]
        out = f.create_dataset(name, rad.shape, "u1")
        for ts in iter_time_slabs(rad.shape, rad.dtype.itemsize, n_buffers=4):
            out[ts] = radiance_threshold(np.asarray(rad[ts], np.float32), np.asarray(bg[ts], np.float32),
                                         a.threshold_val, use_vats=a.use_vats)
    print(f"wrote {name}")


def cmd_polarimetric_setup(a):
    """Grid-sampled Stokes, normals, elevation and incidence averages over
    the frames' Stokes TIFFs (prepare's save_stokes) -> pdata_avg.npz."""
    from wass_tpu_torch.io.image import read_float_tiff
    from wass_tpu_torch.io.workdir import frame_workdirs
    from wass_tpu_torch.post.polarimetric import PolarimetricAccumulator, accumulate_frame

    out = Path(a.outputdir)
    out.mkdir(parents=True, exist_ok=True)
    wds = frame_workdirs(a.wassdir)
    with _read(a.ncfile) as f:
        Pplane = f["meta"][f"P{a.cam}plane"][...]
        Cam2Grid = f["meta"][f"Cam{a.cam}toGrid"][...]
        XX = f["X_grid"][...] / 1000.0
        YY = f["Y_grid"][...] / 1000.0
        Z = f["Z"]
        N = a.numframes if a.numframes > 0 else min(Z.shape[0], len(wds))
        cam_origin = Cam2Grid @ np.array([0.0, 0, 0, 1])
        cam_origin = cam_origin[:3] / cam_origin[3]
        acc = PolarimetricAccumulator.zeros(XX.shape)
        for i in range(N):
            pre = wds[i].path / "undistorted" / f"{a.cam:08d}"
            S0, S1, S2 = (read_float_tiff(f"{pre}_{s}.tiff") for s in ("S0", "S1", "S2"))
            acc = accumulate_frame(acc, Z[i] / 1000.0, XX, YY, S0, S1, S2, Pplane, cam_origin, device=a.device)
    Savg, Navg, Zavg, inc = acc.finalize()
    np.savez(out / "pdata_avg", Savg=Savg, Navg_grid=Navg, Zavg=Zavg, incidence_avg=inc, Cam2Grid=Cam2Grid)
    print(f"polarimetric averages over {N} frames saved to {out / 'pdata_avg.npz'}")


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog=PROG, description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="command", required=True)

    def command(name, fn, help_text):
        p = sub.add_parser(name, aliases=[name.replace("_", "-")] if "_" in name else [], help=help_text)
        p.add_argument("ncfile")
        p.add_argument("--device", default="cuda", choices=("cuda", "cpu"), help=DEVICE_HELP)
        p.set_defaults(fn=fn)
        return p

    command("info", cmd_info, "list the cube's variables and meta attributes")
    p = command("filter", cmd_filter, "zero-phase temporal Butterworth, streamed over column blocks")
    p.add_argument("--cutoff", type=float, default=1.0, help="filter cutoff in Hz")
    kind = p.add_mutually_exclusive_group()
    kind.add_argument("--lowpass", dest="kind", action="store_const", const="lowpass")
    kind.add_argument("--highpass", dest="kind", action="store_const", const="highpass")
    p.set_defaults(kind="lowpass")
    p.add_argument("--filter-variable", default="Z")
    p.add_argument("--overwrite", action="store_true")
    p = command("spatial_lowpass", cmd_spatial_lowpass, "frame-wise radial 2D Butterworth, streamed over time slabs")
    p.add_argument("--cutoff-in-hz", type=float, default=1.0)
    p.add_argument("--filter-variable", default="Z")
    p = command("spectrum", cmd_spectrum, "Welch frequency spectrum and integral wave parameters")
    p.add_argument("--nperseg", type=int, default=512)
    p.add_argument("--rangespan", type=int, default=5)
    p.add_argument("--variable", default="Z")
    p = command("spectrum3d", cmd_spectrum3d, "3D wavenumber-frequency spectrum")
    p.add_argument("--segments", type=int, default=10)
    p = command("setfps", cmd_setfps, "set meta.fps and rewrite time")
    p.add_argument("fps", type=float)
    p = command("zeromean", cmd_zeromean, "per-point temporal zero-mean, two streaming passes")
    p.add_argument("--variable", default="Z")
    p = command("clip", cmd_clip, "clip a variable to [zmin, zmax]")
    p.add_argument("--variable", default="Z")
    p.add_argument("--zmin", type=float, required=True)
    p.add_argument("--zmax", type=float, required=True)
    p = command("visibilitymap", cmd_visibilitymap, "occlusion masks and incidence angles toward a camera")
    p.add_argument("--cam", type=int, default=0)
    p.add_argument("--numframes", type=int, default=-1, help="-1 = all frames")
    p.add_argument("--outputdir", default=None, help="also write per-frame occlusion PNGs here")
    p = command("renamevar", cmd_renamevar, "rename a variable")
    p.add_argument("srcvar")
    p.add_argument("dstvar")
    p = command("radiance", cmd_radiance, "remap camera images onto the elevation grid")
    p.add_argument("--cam", type=int, default=0)
    p.add_argument("--wassdir", default=None, help="sequence dir with *_wd workdirs")
    p.add_argument("--numframes", type=int, default=0)
    p.add_argument("--zvariable", default="Z")
    p = command("bgimage", cmd_bgimage, "time-wise box filter of the radiance")
    p.add_argument("--cam", type=int, default=0)
    p.add_argument("--filtersize", type=int, default=200)
    p = command("radiance_threshold", cmd_radiance_threshold, "background-subtracted binarization")
    p.add_argument("--cam", type=int, default=0)
    p.add_argument("--threshold-val", type=float, default=0.35)
    p.add_argument("--use-vats", action="store_true")
    p = command("polarimetric_setup", cmd_polarimetric_setup, "grid-sampled Stokes, normal and incidence averages")
    p.add_argument("--cam", type=int, default=0)
    p.add_argument("--wassdir", required=True)
    p.add_argument("--outputdir", required=True)
    p.add_argument("--numframes", type=int, default=0)
    return parser


def main(argv=None) -> int:
    parser = _parser()
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    if not Path(args.ncfile).exists():
        parser.error(f"no such file: {args.ncfile}")
    from wass_tpu_torch.device import resolve_device

    resolve_device(args.device)
    try:
        args.fn(args)
    except CommandError as e:
        print(f"{PROG}: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
