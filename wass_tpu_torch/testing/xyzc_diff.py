"""Compare the .xyzC files of two runs, frame by frame.

    python -m wass_tpu_torch.testing.xyzc_diff <dir A> <dir B>

For every mesh_cam.xyzC under dir A (searched recursively) that has a
counterpart at the same relative path under dir B, prints the point
counts, whether the float headers (scales, mins, Rinv, Tinv) are equal,
and the largest difference of the u16 payloads, then the largest over all
files.  Exits 1 when no file has a counterpart.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

HEADER_BYTES = 4 + 8 * (3 + 3 + 9 + 3)  # npts, scales, mins, Rinv, Tinv


def read_xyzc(path):
    """(header bytes after the count, (N, 3) uint16 payload)."""
    raw = Path(path).read_bytes()
    n = int(np.frombuffer(raw[:4], "<u4")[0])
    return raw[4:HEADER_BYTES], np.frombuffer(raw[HEADER_BYTES:], "<u2").reshape(n, 3)


def compare(a, b) -> dict:
    ha, qa = read_xyzc(a)
    hb, qb = read_xyzc(b)
    out = {"points": (len(qa), len(qb)), "header_equal": ha == hb, "max_u16_diff": None}
    if len(qa) == len(qb):
        out["max_u16_diff"] = int(np.abs(qa.astype(np.int32) - qb.astype(np.int32)).max(initial=0))
    return out


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__.strip(), file=sys.stderr)
        return 2
    a_root, b_root = Path(argv[0]), Path(argv[1])
    worst, n = 0, 0
    for a in sorted(a_root.rglob("mesh_cam.xyzC")):
        b = b_root / a.relative_to(a_root)
        if not b.exists():
            continue
        r = compare(a, b)
        n += 1
        if r["max_u16_diff"] is not None:
            worst = max(worst, r["max_u16_diff"])
        print(f"{a.relative_to(a_root)}: points {r['points'][0]} / {r['points'][1]}, "
              f"header {'equal' if r['header_equal'] else 'differs'}, max u16 diff {r['max_u16_diff']}")
    if n == 0:
        print("no .xyzC file with a counterpart", file=sys.stderr)
        return 1
    print(f"{n} files, largest u16 difference {worst}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
