"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, traffic mix, limits and per-layer metrics are
found by name from BENCHMARK.json at the root of the checkout (spec.py).
The run needs as many CUDA devices as the cell asks for; it exits with a
non-zero code and prints no result without them, when it finds no program
to measure, or when JAX or the JAX package was loaded.  What it writes
stays inside the checkout: its sequence under .bench/, removed at the
end, and the program's kernel library, which the program builds into
wass_tpu_torch/_build/ on a checkout's first run.  The last lines on
standard error are the compared numbers with their limits; the last line
on standard output is the result object.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
STATE = ROOT / ".bench"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "BENCHMARK.json").exists() or not (ROOT / "wass_tpu_torch" / "__init__.py").exists():
        print(f"run.py: no BENCHMARK.json or no wass_tpu_torch package under {ROOT}", file=sys.stderr)
        return 2
    sys.path.insert(1, str(ROOT))

    import spec as spec_mod

    spec = spec_mod.load(args.workload, ROOT)
    chips = spec["cell"]["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: the cell needs {chips} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 3

    import cell

    result = cell.run(spec, args.seed % 2**63, args.seconds, bool(args.trace), STATE / "work" / args.workload,
                      device="cuda", chips=chips, t_start=T_START)
    bad = cell.forbidden_modules()
    if bad:
        print(f"run.py: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
