"""wass-tpu-torch command line: `wass-tpu-torch stereo <outdir>`.

The dense stereo stage of the wasscli flow on the port: every frame
workdir (NNNNNN_wd with undistorted PNGs, intrinsics and extrinsics) under
<outdir> is reconstructed, with the options of <outdir>/stereo_config.txt
when it exists and the reference's defaults otherwise.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def load_pipeline(outdir, device: str = "cuda"):
    """SequencePipeline configured from <outdir>/stereo_config.txt."""
    from wass_tpu_torch.cli.options import register_all, stereo_config_from_registry
    from wass_tpu_torch.cli.pipeline import SequenceConfig, SequencePipeline
    from wass_tpu.config import stereo_cfg as reg

    register_all()
    reg.reset()  # no values leak across sequences in one process
    cfgfile = Path(outdir) / "stereo_config.txt"
    if cfgfile.exists():
        reg.load_file(cfgfile)
    return SequencePipeline(outdir, SequenceConfig(stereo=stereo_config_from_registry(), device=device))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="wass-tpu-torch", description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="command", required=True)
    st = sub.add_parser("stereo", help="dense reconstruction of every frame workdir (wass_stereo)")
    st.add_argument("outdir", type=Path)
    st.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda runs the CUDA kernels (default); cpu runs their plain versions")
    args = parser.parse_args(argv)
    if not args.outdir.is_dir():
        parser.error(f"no such directory: {args.outdir}")
    planes = load_pipeline(args.outdir, args.device).stereo()
    print(f"reconstructed {len(planes)} frames")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
