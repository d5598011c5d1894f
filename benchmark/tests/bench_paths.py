"""Puts the benchmark's folder and the checkout's root on sys.path, so the
benchmark's tests import its modules (spec, cell, reference, ...) and the
program as run.py does.  Each test module imports it first."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)
