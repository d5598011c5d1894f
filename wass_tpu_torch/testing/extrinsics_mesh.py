"""The mesh that given extrinsics make of chip_smoke.py's 3 MP pair.

For each named pose of a JSON file ({"name": {"R": 3x3, "T": 3}, ...}),
writes the pair (make_scene seed 7, 2048x1536, wave amplitude 0.25) as
one frame workdir with those extrinsics, runs the port's `stereo`
at the defaults, and prints the trimmed-mean elevation error against the
scene's ground truth (the verify_meshes gate is 0.02) beside the pose's
max |dR| and max |dT| (T normalized) against the rig.  The rig's own pose
runs first.  The last line is one JSON object with the same numbers.

    python -m wass_tpu_torch.testing.extrinsics_mesh POSES.json --cache DIR [--device cuda]

DIR holds the rendered scene (rendered there when missing, minutes at
3 MP) and the frame workdirs.
"""

from __future__ import annotations

import argparse
import io
import json
import shutil
import sys
from pathlib import Path

import numpy as np

from wass_tpu_torch.io.workdir import frame_workdirs
from wass_tpu_torch.testing import load_or_make_scene, read_frame, trimmed_elevation_error, write_sequence


def main(argv=None) -> int:
    from wass_tpu_torch.cli.main import load_pipeline

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("poses", help='JSON file: {"name": {"R": 3x3, "T": 3}, ...}')
    ap.add_argument("--cache", required=True, help="directory of the rendered scene and the workdirs")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    scene = load_or_make_scene(2048, 1536, 7, args.cache)
    rig = scene.rig
    poses = {"rig": (rig.R, rig.T)}
    for name, p in json.loads(Path(args.poses).read_text()).items():
        poses[name] = (np.asarray(p["R"], np.float64), np.asarray(p["T"], np.float64).ravel())
    root = Path(args.cache) / "extrinsics_mesh"
    rows = {}
    for name, (R, T) in poses.items():
        seq = root / name
        shutil.rmtree(seq, ignore_errors=True)
        write_sequence(seq, scene.img0, scene.img1, rig, 1)
        wd = frame_workdirs(seq)[0]
        wd.save_extrinsics(R, T)
        load_pipeline(seq, device=args.device).stereo([wd], progress_stream=io.StringIO())
        plane, mesh, _ = read_frame(wd.path)
        ok = bool(np.all(np.isfinite(plane)) and len(mesh))
        Tn, Tg = T / np.linalg.norm(T), rig.T / np.linalg.norm(rig.T)
        rows[name] = {"dR": float(np.abs(R - rig.R).max()), "dT": float(np.abs(Tn - Tg).max()),
                      "points": int(len(mesh)),
                      "elevation_error": trimmed_elevation_error(scene, mesh, plane) if ok else None}
        print(f"{name}: max |dR| {rows[name]['dR']:.3g}, max |dT| {rows[name]['dT']:.3g}, {len(mesh)} points, "
              f"trimmed-mean elevation error {rows[name]['elevation_error']}", flush=True)
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
