"""Infection-immunization dynamics: a Nash equilibrium over a payoff matrix.

Counterpart of wass_tpu/match/iidyn.py (gt_iidyn of the WASS matcher).
Each iteration picks the best pure-strategy deviation (the infective
strategy), mixes it into the population with the optimal share mu and
updates Ax incrementally from one row of A; `mask` freezes candidates
removed in earlier match rounds out of the game.

The JAX package compiles the loop (up to 20000 iterations a round) into
one lax.while_loop.  Eager PyTorch would pay ~15 launches and a host read
for every iteration, so on a card the loop is one CUDA kernel
(csrc/iidyn.cu): `iidyn` launches it for CUDA tensors and runs
`iidyn_plain`, the same loop in PyTorch ops in the JAX order of
operations, for CPU tensors only.  Both start from the same simplex
projection of x0 and the same product A @ x, and the plain loop adds its
sums in the kernel's order, so the two give the same bits.

The loop's semantics, kept by both versions: an iteration computes the
Nash error of the state before its update and the loop condition reads
that error, so the loop applies one update past the first state that met
err < toll^2; `n_iters` counts updates; the returned error is recomputed
on the final state.  argmax/argmin ties go to the lowest index, and an
argmin over an empty set returns index 0.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from wass_tpu_torch import _build
from wass_tpu_torch.device import on_cuda
from wass_tpu_torch.launches import LaunchCounts

LAUNCHES = LaunchCounts({"iidyn": 0})
# On an H100, above this many candidates x, Ax and the live flags (9 bytes
# each) no longer fit the 227 KB of shared memory a block may use, and the
# kernel keeps x and Ax in global memory (csrc/iidyn.cu picks the variant).
SMEM_MAX_C = (232448 - 1024) // 9


# The kernel's block (csrc/iidyn.cu kThreads): the order of its sums.
THREADS = 1024


def _simplexify(x: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    x = torch.where(live, torch.clamp_min(x, 0.0), 0.0)
    return x / torch.clamp_min(x.sum(), 1e-30)


def _block_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim in the kernel's order: thread t adds v[t],
    v[t + 1024], ... one after another from 0; then the 32 lanes of each
    warp fold in halves (lane l adds lane l + 16, then l + 8, ...: the
    kernel's xor shuffles, whose sums are the same on every lane), and so
    do the 32 warp sums.  Every add is one IEEE float32 add, so the plain
    loop's sums are the kernel's bits."""
    C = v.shape[-1]
    k = -(-C // THREADS)
    p = torch.nn.functional.pad(v, (0, k * THREADS - C)).reshape(*v.shape[:-1], k, THREADS)
    acc = p[..., 0, :] + 0.0
    for j in range(1, k):
        acc = acc + p[..., j, :]
    for width in (THREADS // 32, 1):  # the warps' lanes, then the warp sums
        acc = acc.reshape(*v.shape[:-1], width, 32)
        for h in (16, 8, 4, 2, 1):
            acc = acc[..., :h] + acc[..., h : 2 * h]
    return acc.reshape(v.shape[:-1])


def _select(x: torch.Tensor, Ax: torch.Tensor, live: torch.Tensor):
    """selectStrategy (iidyn.cpp:171-208): (idx, delta, xAx)."""
    xAx = _block_sum(x * Ax)
    Ax_l = torch.where(live, Ax, -torch.inf)
    max_idx = torch.argmax(Ax_l)
    maxv = Ax_l[max_idx] - xAx
    Ax_s = torch.where(live & (x > 0), Ax, torch.inf)
    min_idx = torch.argmin(Ax_s)
    minv = xAx - Ax_s[min_idx]
    use_max = maxv >= minv
    idx = torch.where(use_max, max_idx, min_idx)
    delta = torch.where(use_max, maxv, -minv)
    return idx, delta, xAx


def _err_terms(x: torch.Tensor, Ax: torch.Tensor, xAx: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """The Nash error's terms, min(xAx - Ax_i, x_i)^2 over live."""
    tmp = torch.minimum(xAx - Ax, x)
    return torch.where(live, tmp * tmp, 0.0)


def _start(A: torch.Tensor, x0: torch.Tensor, mask: Optional[torch.Tensor]):
    live = torch.ones(A.shape[0], dtype=torch.bool, device=A.device) if mask is None else mask
    x = _simplexify(x0, live)
    return live, x, A @ x


def iidyn_plain(A: torch.Tensor, x0: torch.Tensor, mask: Optional[torch.Tensor] = None, toll: float = 1e-6,
                max_iters: int = 50000) -> Tuple[torch.Tensor, int, torch.Tensor]:
    """The loop in PyTorch ops, with the kernel's sums (_block_sum) and its
    float32 toll^2; reads the error on the host every iteration."""
    live, x, Ax = _start(A, x0, mask)
    toll2 = float(torch.tensor(toll * toll, dtype=torch.float32))
    it, err = 0, float("inf")
    while it < max_iters and err >= toll2:
        idx, delta, xAx = _select(x, Ax, live)
        den = A[idx, idx] - Ax[idx] - delta
        q = -delta / den
        mu_pos = torch.where(den < 0, torch.clamp(q, 0.0, 1.0), 1.0)
        mu0 = x[idx] / (x[idx] - 1.0)
        raised = (den < 0) & (q > mu0)
        mu_neg = torch.where(raised, torch.clamp_max(q, 0.0), mu0)
        remove = (delta < 0) & ~raised
        mu = torch.where(delta >= 0, mu_pos, mu_neg)
        x_new = x * (1.0 - mu)
        x_new[idx] = torch.where(remove, 0.0, x_new[idx] + mu)
        x_new = torch.where(live, torch.clamp_min(x_new, 0.0), 0.0)
        # The simplex sum of the next state and the error of this one, in one
        # reduction as the kernel's second pass.
        sum_err = _block_sum(torch.stack([x_new, _err_terms(x, Ax, xAx, live)]))
        Ax = Ax + mu * (A[idx, :] - Ax)
        x = x_new / torch.clamp_min(sum_err[0], 1e-30)
        it += 1
        err = float(sum_err[1])
    final_err = _block_sum(_err_terms(x, Ax, _block_sum(x * Ax), live))
    return x, it, torch.sqrt(final_err)


def iidyn(A: torch.Tensor, x0: torch.Tensor, mask: Optional[torch.Tensor] = None, toll: float = 1e-6,
          max_iters: int = 50000) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the dynamics.

    A: (C, C) float32 payoff (symmetric, nonnegative); x0: (C,) initial
    population (need not be normalized); mask: (C,) bool, False entries are
    frozen out; toll: Nash-error tolerance, squared inside; max_iters:
    iteration cap.  Returns (x, n_iters, nash_error); on a card n_iters and
    nash_error are 0-dim device tensors that the host has not read.
    """
    if not on_cuda(A, x0, *(() if mask is None else (mask,))):
        x, it, err = iidyn_plain(A, x0, mask, toll, max_iters)
        return x, torch.tensor(it, dtype=torch.int32), err
    C = A.shape[0]
    if A.dtype != torch.float32 or A.shape != (C, C) or not A.is_contiguous():
        raise ValueError("A must be a contiguous (C, C) float32 tensor")
    if x0.shape != (C,) or x0.dtype != torch.float32 or (mask is not None and (mask.shape != (C,) or mask.dtype != torch.bool)):
        raise ValueError("x0 must be (C,) float32 and mask (C,) bool")
    live, x, Ax = _start(A, x0, mask)
    x, Ax = x.contiguous(), Ax.contiguous()
    live8 = live.to(torch.uint8).contiguous()
    it = torch.empty((), dtype=torch.int32, device=A.device)
    err = torch.empty((), dtype=torch.float32, device=A.device)
    lib = _build.load()
    code = lib.wass_iidyn(A.data_ptr(), x.data_ptr(), Ax.data_ptr(), live8.data_ptr(), it.data_ptr(), err.data_ptr(),
                          C, float(toll) * float(toll), int(max_iters), _build.stream_handle(A.device))
    _build.check(code, "iidyn kernel")
    LAUNCHES.add("iidyn")
    return x, it, err


def initial_population(u: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Barycenter + up to 3% jitter (gt_create_population, iidyn.cpp:601-612)
    from u, (C,) uniform draws in [0, 1)."""
    x = 1.0 + u * (u.shape[0] * 0.03)
    if mask is not None:
        x = torch.where(mask, x, 0.0)
    return x / x.sum()
