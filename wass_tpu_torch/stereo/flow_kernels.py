"""Wrappers of the flow solver's CUDA kernels and their plain versions.

Counterparts of the two steps of wass_tpu/stereo/flow.py:variational_refine,
a compiled JAX loop (csrc/flow.cu):

* `flow_linearize`: an outer iteration's warp and linearisation
  (outer_body, :248-259).  At px = x + u, py = y + v it samples I1 and its
  gradients bilinearly (0 outside the image), and gives It = I1(p + w) - I0,
  Ix, Iy and the robust data weight wdata = inb / sqrt(It^2 + 1e-3), inb
  the warp staying one pixel inside the border.  Its u, v are the sweeps'
  warp point u0, v0 (the caller sweeps into other buffers).
* `flow_jacobi`: one Jacobi sweep of the linearised Horn-Schunck system
  (:261-270): the 8-neighbour average (1/12, 1/6, zero-padded) and the
  update u' = ubar - wdata Ix r / den, v' likewise.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version (op by op in PyTorch, in the kernel's order, so the two agree bit
for bit on the card) for CPU tensors only.  The JAX function sums its
average with XLA's convolution, in an order nobody has reproduced, so the
plain versions agree with it within the tolerance the tests state.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from wass_tpu_torch import _build
from wass_tpu_torch.device import on_cuda
from wass_tpu_torch.instrument import LaunchCounts
from wass_tpu_torch.ops.sampling import bilinear_sample

LAUNCHES = LaunchCounts({"flow_linearize": 0, "flow_jacobi": 0})

CORNER = 1.0 / 12.0  # the average's weights (rounded to float32 as PyTorch rounds a scalar)
EDGE = 1.0 / 6.0
EPS2 = 1e-3  # the Charbonnier weight's epsilon


def _check(name: str, *fields: torch.Tensor) -> None:
    shape = fields[0].shape
    if len(shape) != 2 or any(f.shape != shape for f in fields):
        raise ValueError(f"{name}: fields of one (H, W) shape expected, got {[tuple(f.shape) for f in fields]}")
    if any(f.dtype != torch.float32 for f in fields):
        raise ValueError(f"{name}: float32 fields expected")
    if not all(f.is_contiguous() for f in fields):
        raise ValueError(f"{name}: contiguous fields expected")


def flow_linearize_plain(I0, I1, g1x, g1y, u, v):
    H, W = I0.shape
    px = torch.arange(W, dtype=torch.float32, device=I0.device)[None, :] + u
    py = torch.arange(H, dtype=torch.float32, device=I0.device)[:, None] + v
    It = bilinear_sample(I1, px, py, fill=0.0) - I0
    Ix = bilinear_sample(g1x, px, py, fill=0.0)
    Iy = bilinear_sample(g1y, px, py, fill=0.0)
    inb = ((px >= 1) & (px <= W - 2) & (py >= 1) & (py <= H - 2)).to(torch.float32)
    wdata = inb / torch.sqrt(It * It + EPS2)
    return It, Ix, Iy, wdata


def flow_linearize(I0, I1, g1x, g1y, u, v):
    """I0, I1 (H, W) float32 images, g1x, g1y I1's gradients, u, v the flow,
    all contiguous on one device -> (It, Ix, Iy, wdata), each (H, W)."""
    _check("flow_linearize", I0, I1, g1x, g1y, u, v)
    if not on_cuda(I0, I1, g1x, g1y, u, v):
        return flow_linearize_plain(I0, I1, g1x, g1y, u, v)
    H, W = I0.shape
    out = torch.empty((4, H, W), dtype=torch.float32, device=I0.device)
    _build.launch("wass_flow_linearize", "flow_linearize kernel", I0.device,
                  I0.data_ptr(), I1.data_ptr(), g1x.data_ptr(), g1y.data_ptr(), u.data_ptr(), v.data_ptr(),
                  *(o.data_ptr() for o in out), H, W)
    LAUNCHES.add("flow_linearize")
    return tuple(out.unbind(0))


def average(x: torch.Tensor) -> torch.Tensor:
    """The 8-neighbour Horn-Schunck average, zero-padded, its taps summed
    row by row, left to right (the kernel's order)."""
    H, W = x.shape
    p = F.pad(x, (1, 1, 1, 1))
    taps = [(0, 0, CORNER), (0, 1, EDGE), (0, 2, CORNER), (1, 0, EDGE), (1, 2, EDGE), (2, 0, CORNER), (2, 1, EDGE),
            (2, 2, CORNER)]
    acc = None
    for dy, dx, w in taps:
        term = p[dy:dy + H, dx:dx + W] * w
        acc = term if acc is None else acc + term
    return acc


def flow_jacobi_plain(u, v, u0, v0, It, Ix, Iy, wdata, lam: float):
    ubar = average(u)
    vbar = average(v)
    r = It + Ix * (ubar - u0) + Iy * (vbar - v0)
    den = lam + wdata * (Ix * Ix + Iy * Iy)
    return ubar - wdata * Ix * r / den, vbar - wdata * Iy * r / den


def flow_jacobi(u, v, u0, v0, It, Ix, Iy, wdata, lam: float, out=None):
    """One sweep from the flow (u, v), the warp point (u0, v0) and the
    linearisation (It, Ix, Iy, wdata), all (H, W) float32 contiguous on one
    device; lam the float32 smoothness alpha / delta.  -> (u', v'), written
    into out (two tensors that alias none of the inputs) when given."""
    _check("flow_jacobi", u, v, u0, v0, It, Ix, Iy, wdata)
    if not on_cuda(u, v, u0, v0, It, Ix, Iy, wdata):
        return flow_jacobi_plain(u, v, u0, v0, It, Ix, Iy, wdata, lam)
    H, W = u.shape
    if out is None:
        out = (torch.empty_like(u), torch.empty_like(v))
    un, vn = out
    _check("flow_jacobi out", u, un, vn)
    if any(o.data_ptr() == t.data_ptr() for o in out for t in (u, v, u0, v0, It, Ix, Iy, wdata)):
        raise ValueError("flow_jacobi: out aliases an input")
    _build.launch("wass_flow_jacobi", "flow_jacobi kernel", u.device,
                  u.data_ptr(), v.data_ptr(), u0.data_ptr(), v0.data_ptr(), It.data_ptr(), Ix.data_ptr(), Iy.data_ptr(),
                  wdata.data_ptr(), un.data_ptr(), vn.data_ptr(), H, W, ctypes.c_float(lam))
    LAUNCHES.add("flow_jacobi")
    return un, vn
