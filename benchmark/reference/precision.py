"""The reference's arithmetic precision, and the lower one of its control.

The configuration states float32 with TF32 off for the dense frame (the
plane fit's products are full float32) and float64 for the debug renders.
The control of the correctness check is this reference computed one step
lower: every operand of the frame's matrix products (the RANSAC scoring,
the plane fit's centroid and covariance, the plane transform) rounded to
TF32's 10-bit mantissa, as a TF32 tensor core reads it, and the renders in
float32.  The rounding is written out, so the control is the same on the
CPU and on a card.
"""

from __future__ import annotations

import contextlib

import torch

STATE = {"tf32": False, "render_dtype": torch.float64}


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x unchanged, or, under lower(), its float32 values rounded to the
    nearest TF32 value (ties away from zero, as cvt.rna.tf32.f32)."""
    if not STATE["tf32"] or x.dtype != torch.float32:
        return x
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    finite = torch.isfinite(x)
    return torch.where(finite, rounded.view(torch.float32), x)


def render_dtype() -> torch.dtype:
    return STATE["render_dtype"]


@contextlib.contextmanager
def lower():
    """The control's precision for the block: TF32 products, float32 renders."""
    saved = dict(STATE)
    STATE.update(tf32=True, render_dtype=torch.float32)
    try:
        yield
    finally:
        STATE.update(saved)
