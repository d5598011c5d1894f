"""wass-tpu-torch command line: prepare, match, autocalibrate, stereo, measure and genconfig.

The wasscli flow on the port:

  prepare CAM0_DIR CAM1_DIR CALIBDIR OUTDIR   raw frame pairs -> frame workdirs
  match OUTDIR                                sparse matches and a pose for
                                              a subset of the frames
  autocalibrate OUTDIR                        the rig's extrinsics from the
                                              pooled matches, written to
                                              every frame workdir
  stereo OUTDIR                               dense reconstruction of every
                                              frame workdir under OUTDIR
  measure WORKDIR U0 V0 U1 V1 [--baseline B] [--radius R]
                                              the 3D distance between the
                                              mesh points nearest two cam0
                                              pixels of a reconstructed frame
  genconfig OUTDIR --stage {prepare,matcher,stereo}   the commented option file

match and stereo read <outdir>/matcher_config.txt and
<outdir>/stereo_config.txt when they exist and take the reference's
defaults otherwise.  prepare, as the JAX package's command, takes the
default prepare options and reads no prepare_config.txt.  Raw frames are
any image OpenCV decodes, read as the JAX command reads them
(io/image.py:read_raw_frame).  measure's --interactive picker is refused:
it needs matplotlib, which the port does without.

stereo spreads the frames over every local card (one frame a card a
batch).  Started by torchrun (WORLD_SIZE > 1 in the environment), it
joins the torchrun group first ("nccl", one card a rank; "gloo" with
--device cpu) and each rank runs the frames of its own card:

  torchrun --nproc_per_node=4 -m wass_tpu_torch.cli.main stereo OUTDIR
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

DEVICE_HELP = "cuda runs the CUDA kernels (default); cpu runs their plain versions"


def load_pipeline(outdir, device: str = "cuda"):
    """SequencePipeline configured from <outdir>/{prepare,matcher,stereo}_config.txt."""
    from wass_tpu_torch.cli.options import (
        flow_config_from_registry,
        match_config_from_registry,
        prepare_config_from_registry,
        register_all,
        stereo_config_from_registry,
    )
    from wass_tpu_torch.cli.pipeline import SequenceConfig, SequencePipeline
    from wass_tpu_torch.config import registry

    register_all()
    for stage in ("prepare", "matcher", "stereo"):
        reg = registry(stage)
        reg.reset()  # no values leak across sequences in one process
        cfgfile = Path(outdir) / f"{stage}_config.txt"
        if cfgfile.exists():
            reg.load_file(cfgfile)
    cfg = SequenceConfig(prepare=prepare_config_from_registry(), match=match_config_from_registry(),
                         stereo=stereo_config_from_registry(), flow=flow_config_from_registry(), device=device)
    return SequencePipeline(outdir, cfg)


def read_raw_frame(path) -> np.ndarray:
    """A raw frame as float32 (io/image.py); exits naming a file that does
    not decode."""
    from wass_tpu_torch.io import image

    try:
        return image.read_raw_frame(path)
    except (ValueError, OSError) as e:
        raise SystemExit(f"wass-tpu-torch prepare: cannot read the raw frame {path}: {e}")


def prepare(cam0_dir: Path, cam1_dir: Path, calibdir: Path, outdir: Path, continue_if_existing: bool,
            device: str) -> int:
    """Prepare all frame pairs into workdirs (wass_prepare)."""
    from wass_tpu_torch.cli.pipeline import SequenceConfig, SequencePipeline
    from wass_tpu_torch.io.matrices import load_matrix
    from wass_tpu_torch.prepare.prepare import prepare_frame
    from wass_tpu_torch.utils.progress import progress

    K0 = load_matrix(calibdir / "intrinsics_00.xml")
    K1 = load_matrix(calibdir / "intrinsics_01.xml")
    # Distortion files are optional (wass_prepare.cpp:433-443: "Assuming no
    # distortion" when absent).
    d0, d1 = (load_matrix(calibdir / f"distortion_0{c}.xml").reshape(-1)
              if (calibdir / f"distortion_0{c}.xml").exists() else np.zeros(5) for c in (0, 1))
    ext_R = ext_T = None
    if (calibdir / "ext_R.xml").exists():
        ext_R = load_matrix(calibdir / "ext_R.xml")
        ext_T = load_matrix(calibdir / "ext_T.xml")

    f0 = sorted(cam0_dir.glob("*"))
    f1 = sorted(cam1_dir.glob("*"))
    if len(f0) != len(f1):
        raise SystemExit("wass-tpu-torch prepare: camera folders contain different frame counts")

    pipe = SequencePipeline(outdir, SequenceConfig(device=device))
    dev = pipe._device()
    for i, (a, b) in enumerate(zip(f0, f1)):
        wd_path = pipe.outdir / f"{i:06d}_wd"
        if continue_if_existing and (wd_path / "undistorted" / "00000001.png").exists():
            continue
        prepare_frame(wd_path, read_raw_frame(a), read_raw_frame(b), K0, d0, K1, d1, pipe.cfg.prepare,
                      ext_R, ext_T, device=dev)
        progress(i + 1, len(f0))
    print(f"prepared {len(f0)} frames into {outdir}")
    return 0


def measure(workdir: Path, pixels, baseline, radius: float) -> int:
    """Two-point 3D distance on a reconstructed frame (the wass_stereo
    --measure workflow, wass_stereo.cpp:1934-1973): each cam0 pixel is
    snapped to the nearest mesh point reprojected through K0."""
    from wass_tpu_torch.io.workdir import Workdir
    from wass_tpu_torch.stereo.meshops import measure_distance

    wd = Workdir(workdir)
    mesh = wd.load_mesh_cam()  # (3, N) cam0-frame, baseline units
    if mesh.shape[1] == 0:
        raise SystemExit("wass-tpu-torch measure: empty mesh_cam.xyzC")
    uv = wd.load_intrinsics(0) @ mesh
    uv = uv[:2] / uv[2:3]
    picked = []
    for u, v in ((pixels[0], pixels[1]), (pixels[2], pixels[3])):
        d2 = (uv[0] - u) ** 2 + (uv[1] - v) ** 2
        j = int(np.argmin(d2))
        if d2[j] > radius * radius:
            raise SystemExit(f"wass-tpu-torch measure: no reconstructed point within {radius:g} px of ({u:g}, {v:g})")
        p = mesh[:, j]
        print(f"({u:g}, {v:g}) -> point #{j} at [{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}] "
              f"(reprojects to {uv[0][j]:.1f}, {uv[1][j]:.1f})")
        picked.append(p)
    dist = float(measure_distance(picked[0], picked[1]))
    print(f"distance: {dist:.6f} baseline units")
    if baseline is not None:
        print(f"distance: {dist * baseline:.6f} m (baseline {baseline:g} m)")
    return 0


def genconfig(outdir: Path, stage: str) -> int:
    """Write the commented key=value options of a stage (--genconfig)."""
    from wass_tpu_torch.cli.options import register_all
    from wass_tpu_torch.config import registry

    register_all()
    out = outdir / f"{stage}_config.txt" if outdir.is_dir() else outdir
    out.write_text(registry(stage).to_config_string())
    print(f"wrote {out}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="wass-tpu-torch", description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="command", required=True)
    pr = sub.add_parser("prepare", help="prepare all frame pairs into workdirs (wass_prepare)")
    for name in ("cam0_dir", "cam1_dir", "calibdir"):
        pr.add_argument(name, type=Path)
    pr.add_argument("outdir", type=Path)
    pr.add_argument("--continue-if-existing", action="store_true", help="skip frames whose workdir is complete")
    pr.add_argument("--device", default="cuda", choices=("cuda", "cpu"), help=DEVICE_HELP)
    for name, text in (("match", "feature-match a random subset of frames (wass_match)"),
                       ("autocalibrate", "sequence-wide extrinsic refinement (wass_autocalibrate)"),
                       ("stereo", "dense reconstruction of every frame workdir (wass_stereo)")):
        stage = sub.add_parser(name, help=text)
        stage.add_argument("outdir", type=Path)
        stage.add_argument("--device", default="cuda", choices=("cuda", "cpu"), help=DEVICE_HELP)
    me = sub.add_parser("measure", help="two-point 3D distance on a reconstructed frame")
    me.add_argument("workdir", type=Path)
    me.add_argument("pixels", nargs="*", type=float, help="U0 V0 U1 V1: two cam0 pixels")
    me.add_argument("--baseline", type=float, default=None,
                    help="camera baseline in meters; scales the distance from baseline units to meters")
    me.add_argument("--radius", type=float, default=10.0,
                    help="max pixel distance between a requested pixel and the nearest reconstructed point")
    me.add_argument("--interactive", action="store_true",
                    help="pick the points on the cam0 image (refused: the port has no matplotlib)")
    gc = sub.add_parser("genconfig", help="write a stage's commented option file")
    gc.add_argument("outdir", type=Path)
    gc.add_argument("--stage", default="stereo", choices=("prepare", "matcher", "stereo"))
    args = parser.parse_args(argv)

    if args.command == "prepare":
        for d in (args.cam0_dir, args.cam1_dir, args.calibdir):
            if not d.is_dir():
                parser.error(f"no such directory: {d}")
        return prepare(args.cam0_dir, args.cam1_dir, args.calibdir, args.outdir, args.continue_if_existing,
                       args.device)
    if args.command == "genconfig":
        return genconfig(args.outdir, args.stage)
    if args.command == "measure":
        if args.interactive:
            parser.error("--interactive needs matplotlib's point picker, which the port does without; "
                         "give the two pixels as U0 V0 U1 V1")
        if len(args.pixels) != 4:
            parser.error("expected 4 coordinates: U0 V0 U1 V1")
        if not args.workdir.is_dir():
            parser.error(f"no such directory: {args.workdir}")
        return measure(args.workdir, args.pixels, args.baseline, args.radius)
    if not args.outdir.is_dir():
        parser.error(f"no such directory: {args.outdir}")
    pipe = load_pipeline(args.outdir, args.device)
    if args.command == "match":
        print(f"matched {pipe.match()} frames")
    elif args.command == "autocalibrate":
        res = pipe.autocalibrate()
        if res is None:
            print("wass-tpu-torch autocalibrate: autocalibration failed (no matches?)", file=sys.stderr)
            return 1
        print(f"epipolar error {res.epi_med_before:.4f} -> {res.epi_med_after:.4f} px "
              f"({res.n_inliers} inliers, {'accepted' if res.improved else 'kept RANSAC pose'})")
    else:
        import os

        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            from wass_tpu_torch.parallel.runner import initialize_multihost

            initialize_multihost("env://", backend="gloo" if args.device == "cpu" else "nccl")
        print(f"reconstructed {len(pipe.stereo())} frames")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
