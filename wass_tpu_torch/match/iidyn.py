"""Infection-immunization dynamics: a Nash equilibrium over a payoff matrix.

Counterpart of wass_tpu/match/iidyn.py (gt_iidyn of the WASS matcher).
Each iteration picks the best pure-strategy deviation (the infective
strategy), mixes it into the population with the optimal share mu and
updates Ax incrementally from one row of A; `mask` freezes candidates
removed in earlier match rounds out of the game.

The JAX package compiles the loop (up to 20000 iterations a round) into
one lax.while_loop.  Eager PyTorch would pay ~15 launches and a host read
for every iteration, so on a card the loop is one CUDA kernel
(csrc/iidyn.cu, one thread-block cluster): `iidyn` launches it for CUDA
tensors and runs `iidyn_plain`, the same loop in PyTorch ops, for CPU
tensors only.  Both start from the same simplex projection of x0 and the
same product A @ x.  The plain loop keeps the JAX order of operations
except where the kernel fuses an update's reductions into one (xAx is
sum(x~ . Ax) / sum(x~) over the unnormalized population x~, JAX's is
(x~ / sum(x~)) . Ax), and it adds its sums in the kernel's order, so the
two give the same bits.

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
from wass_tpu_torch.instrument import LaunchCounts

LAUNCHES = LaunchCounts({"iidyn": 0})

# The kernel's cluster, fixed in csrc/iidyn.cu (kGroups, kThreads): GROUPS
# CTAs of THREADS threads, the order of its sums.  _layout and _block_sum
# read them at call time, so that a host emulation of the kernel built at
# another shape can set them to its own.
GROUPS = 16
THREADS = 256
# wass_iidyn's code when no cluster of that shape fits the card.
_NO_CLUSTER = -2


def _simplexify(x: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    x = torch.where(live, torch.clamp_min(x, 0.0), 0.0)
    return x / torch.clamp_min(x.sum(), 1e-30)


def _layout(live: torch.Tensor) -> torch.Tensor:
    """The kernel's places of the live candidates: a (GROUPS, K, THREADS)
    index into the candidates, C where no candidate sits.  Of the L live
    candidates in index order, CTA g holds those of rank [g L // GROUPS,
    (g + 1) L // GROUPS), and thread t of a CTA its elements t,
    t + THREADS, ... (element j at [g, j // THREADS, j % THREADS])."""
    C = live.shape[0]
    cols = torch.nonzero(live).flatten()
    L = len(cols)
    bounds = [g * L // GROUPS for g in range(GROUPS + 1)]
    k = max(1, -(-max(hi - lo for lo, hi in zip(bounds, bounds[1:])) // THREADS))
    idx = torch.full((GROUPS, k * THREADS), C, dtype=torch.long, device=live.device)
    for g in range(GROUPS):
        idx[g, : bounds[g + 1] - bounds[g]] = cols[bounds[g] : bounds[g + 1]]
    return idx.reshape(GROUPS, k, THREADS)


def _block_sum(v: torch.Tensor, layout: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim (the candidates) in the kernel's order: thread
    t of CTA g adds its elements one after another from 0 (layout: the
    live candidates only); the 32 lanes of each warp fold in halves (lane
    l adds lane l + 16, then l + 8, ...: the kernel's xor shuffles, whose
    sums are the same on every lane), then so do the THREADS / 32 warp
    sums, and then the GROUPS CTA sums.  Every add is one IEEE float32
    add, so the plain loop's sums are the kernel's bits."""
    G, k, T = layout.shape
    lead = v.shape[:-1]
    p = torch.cat([v, v.new_zeros(*lead, 1)], -1)[..., layout]
    acc = p[..., 0, :] + 0.0
    for j in range(1, k):
        acc = acc + p[..., j, :]
    acc = acc.reshape(*lead, G, T // 32, 32)
    for h in (16, 8, 4, 2, 1):  # the lanes of each warp
        acc = acc[..., :h] + acc[..., h : 2 * h]
    acc = acc.reshape(*lead, G, T // 32)
    for width in (T // 32, G):  # the warp sums, then the CTA sums
        while width > 1:
            width //= 2
            acc = acc[..., :width] + acc[..., width : 2 * width]
        acc = acc[..., 0]
    return acc


def _select(x: torch.Tensor, Ax: torch.Tensor, xAx: torch.Tensor, live: torch.Tensor):
    """selectStrategy (iidyn.cpp:171-208): (idx, delta).  x may be the
    unnormalized population: only its x > 0 set is read."""
    Ax_l = torch.where(live, Ax, -torch.inf)
    max_idx = torch.argmax(Ax_l)
    maxv = Ax_l[max_idx] - xAx
    Ax_s = torch.where(live & (x > 0), Ax, torch.inf)
    min_idx = torch.argmin(Ax_s)
    minv = xAx - Ax_s[min_idx]
    use_max = maxv >= minv
    return torch.where(use_max, max_idx, min_idx), torch.where(use_max, maxv, -minv)


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
    """The loop in PyTorch ops, in the kernel's order: the population is
    kept unnormalized (xt, divided by its sum `denom` where the JAX loop
    reads x), an update's one reduction (_block_sum) gives the next
    state's sum, its xAx (sum xt . Ax / denom) and the error of the state
    before the update; float32 toll^2.  Reads the error on the host every
    iteration."""
    live, xt, Ax = _start(A, x0, mask)
    layout = _layout(live)
    toll2 = float(torch.tensor(toll * toll, dtype=torch.float32))
    denom = torch.ones((), dtype=A.dtype, device=A.device)  # the given x sums to 1
    xAx = _block_sum(xt * Ax, layout) / denom
    it, err = 0, float("inf")
    while it < max_iters and err >= toll2:
        idx, delta = _select(xt, Ax, xAx, live)
        x = xt / denom
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
        err_terms = _err_terms(x, Ax, xAx, live)
        Ax = Ax + mu * (A[idx, :] - Ax)
        sums = _block_sum(torch.stack([x_new, x_new * Ax, err_terms]), layout)
        xt = x_new
        denom = torch.clamp_min(sums[0], 1e-30)
        xAx = sums[1] / denom
        it += 1
        err = float(sums[2])
    x = xt / denom
    return x, it, torch.sqrt(_block_sum(_err_terms(x, Ax, xAx, live), layout))


def iidyn(A: torch.Tensor, x0: torch.Tensor, mask: Optional[torch.Tensor] = None, toll: float = 1e-6,
          max_iters: int = 50000) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the dynamics.

    A: (C, C) float32 payoff (symmetric, nonnegative); x0: (C,) initial
    population (need not be normalized); mask: (C,) bool, False entries are
    frozen out; toll: Nash-error tolerance, squared inside; max_iters:
    iteration cap.  Returns (x, n_iters, nash_error); on a card n_iters and
    nash_error are 0-dim device tensors that the host has not read.  On a
    card the cluster's shared memory holds up to ~229k candidates (16
    bytes a candidate in each of GROUPS CTAs); above that the launch fails
    and raises.
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
    code = _build.launch("wass_iidyn", "iidyn kernel", A.device,
                         A.data_ptr(), x.data_ptr(), Ax.data_ptr(), live8.data_ptr(), it.data_ptr(), err.data_ptr(),
                         C, float(toll) * float(toll), int(max_iters), accept=(_NO_CLUSTER,))
    if code == _NO_CLUSTER:
        raise RuntimeError(f"iidyn kernel: no cluster of {GROUPS} CTAs x {THREADS} threads fits this card "
                           "(cudaOccupancyMaxActiveClusters is 0)")
    LAUNCHES.add("iidyn")
    return x, it, err


def initial_population(u: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Barycenter + up to 3% jitter (gt_create_population, iidyn.cpp:601-612)
    from u, (C,) uniform draws in [0, 1)."""
    x = 1.0 + u * (u.shape[0] * 0.03)
    if mask is not None:
        x = torch.where(mask, x, 0.0)
    return x / x.sum()
