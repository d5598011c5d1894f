"""Match and autocalibrate stage times of one checkout, for comparing two
checkouts of the repository on one card in one call.

    python wass_tpu_torch/testing/match_ab.py <checkout> <pair.npz> <work dir>

imports the port and `chip_smoke.py` from <checkout> (this script may come
from another checkout), writes `chip_smoke.py` phase M's sequence there
(MATCH_FRAMES workdirs of the pair without extrinsics, the phase's
`matcher_config.txt`) under <work dir>, runs `match` and `autocalibrate`
through the CLI once (first-use costs; autocalibrate reads the matches),
then `chip_smoke.profile_match` twice: each match and autocalibrate
stage's device ms (CUDA events) and the wall times, after the card's name
and power limit.  Run it for parent, change, change, parent.  If
<pair.npz> does not exist, it is made first from the smoke scene (seed
SCENE_SEED of the 2048x1536 rig), traced on the card by <checkout>'s
`testing.synthetic.render_pair`.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path


def main(argv) -> int:
    if len(argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    root, pair_path, work = (Path(a).resolve() for a in argv)
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import chip_smoke as cs
    import wass_tpu_torch
    from wass_tpu_torch import _build
    from wass_tpu_torch.cli.main import main as cli_main
    from wass_tpu_torch.testing import write_sequence
    from wass_tpu_torch.testing.synthetic import make_rig

    for mod in (cs, wass_tpu_torch):
        if root not in Path(mod.__file__).resolve().parents:
            raise RuntimeError(f"{mod.__name__} was imported from {mod.__file__}, not from {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _build.load()
    rig = make_rig(width=cs.W, height=cs.H)
    if not pair_path.exists():
        from wass_tpu_torch.testing import WAVE_AMPLITUDE
        from wass_tpu_torch.testing.synthetic import render_pair

        img0, img1 = render_pair(cs.SCENE_SEED, rig, torch.device("cuda"), WAVE_AMPLITUDE)
        np.savez(pair_path, img0=img0, img1=img1)
    pair = np.load(pair_path)
    seq = work / f"match_ab_{root.name}"
    write_sequence(seq, pair["img0"], pair["img1"], rig, cs.MATCH_FRAMES)
    for wd in seq.glob("*_wd"):
        (wd / "ext_R.xml").unlink()
        (wd / "ext_T.xml").unlink()
    (seq / "matcher_config.txt").write_text(f"FEATURE_HESSIAN_THRESHOLD={cs.MATCH_HESSIAN}\n")
    if cli_main(["match", str(seq)]) != 0 or cli_main(["autocalibrate", str(seq)]) != 0:
        raise RuntimeError("match or autocalibrate failed")
    for rep in range(2):
        print(f"== {root} ({smi}), profile {rep}", flush=True)
        cs.profile_match(seq, rig)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
