"""The control of the correctness check, at a cell's own size on the card.

    python3 benchmark/control.py --workload <name> --seeds 11 12 13 [--frames 2]

For each seed it traces that run's sea, computes the plain reference of
`frames` pairs and the reference one precision lower (TF32 products, float32
renders: reference/precision.py), writes the lower one's files as the
program's writers do (plane.txt, mesh_cam.xyzC, the JPEG renders), holds
those files to the reference as a run holds the program's (compare.py),
and prints one JSON line a seed: the readings, and `correct` with each
number beside its limit from limits/<config>.json, as a run prints them.
The limits lie between the largest reading of sound runs and the smallest
reading of this control, so every line should read `correct` false.  The
files go under .bench/control/ in the checkout.  The benchmark's own runs
do not run it.
"""

import argparse
import json
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--frames", type=int, default=2)
    args = ap.parse_args(argv)
    import torch

    import cell
    import spec as spec_mod

    if not torch.cuda.is_available():
        print("control.py: needs a CUDA device", file=sys.stderr)
        return 3
    spec = spec_mod.load(args.workload)
    work = Path(__file__).resolve().parent.parent / ".bench" / "control"
    for seed in args.seeds:
        readings = cell.control_readings(spec, seed % 2**63, "cuda", args.frames, work)
        correct, checks = cell.compare.verdict(cell.compare.worst(readings), spec["limits"])
        print(json.dumps({"workload": args.workload, "seed": seed, "frames": readings, "correct": correct,
                          "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
