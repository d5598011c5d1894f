"""The table of peaks the roofline shares are taken against.

Memory: NVIDIA's H100 SXM data sheet, 3.35 TB/s of HBM3.  Operations: the
CUDA C++ Programming Guide's table of arithmetic instruction throughput,
compute capability 9.0, in results a clock per SM: 16-bit floating-point
add / multiply / multiply-add 256 (a packed pair counts as two results),
32-bit floating-point 128, 32-bit integer add, compare, minimum and maximum
64.  The SGM's min-plus recurrence is adds, minima and compares of small
integers, which any of these units can compute (the Hopper DPX
instructions fuse an add and a minimum over two 16-bit halves, four
results), so 256 results a clock per SM, both halves of a packed op
counted, is an upper bound on any implementation's rate.  The card's SM
count comes from torch and its maximum SM clock from nvidia-smi, so the
bound follows a card with another count or clock.
"""

from __future__ import annotations

import functools
import subprocess

HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}
OPS_PER_CLOCK_PER_SM = 256


@functools.lru_cache(maxsize=None)
def max_sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits", "-i", "0"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.split()[0]) * 1e6


@functools.lru_cache(maxsize=None)
def card() -> dict:
    """The card's name, its peaks, and where they came from; {} when the
    table has no memory rate for the card."""
    import torch

    name = torch.cuda.get_device_name(0)
    if name not in HBM_BYTES_PER_S:
        return {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = max_sm_clock_hz()
    return {"name": name, "bytes_per_s": HBM_BYTES_PER_S[name], "ops_per_s": sms * OPS_PER_CLOCK_PER_SM * clock,
            "sms": sms, "clock_hz": clock}


def least_seconds(nbytes: float, ops: float, peaks: dict) -> tuple:
    """(seconds, "bytes" or "operations"): the least time for work that must
    move nbytes and compute ops, whichever bound is larger."""
    t_bytes = nbytes / peaks["bytes_per_s"]
    t_ops = ops / peaks["ops_per_s"]
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
