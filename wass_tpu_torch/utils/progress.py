"""The [P|cur|tot] machine-readable progress protocol.

The port's own copy of wass_tpu/utils/progress.py: the reference emits
`[P|cur|tot]` lines on stdout so external monitors can track each stage
(wass_prepare.cpp:426, wass_match.cpp:232, wass_stereo.cpp:2139 of the
WASS sources).  Same text here.
"""

from __future__ import annotations

import sys


def progress(cur: int, tot: int = 100, stream=None) -> None:
    (stream or sys.stdout).write(f"[P|{int(cur)}|{int(tot)}]\n")
    (stream or sys.stdout).flush()
