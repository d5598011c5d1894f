"""Game-theoretic feature matching.

Counterpart of wass_tpu/match/matcher.py (the WASS GTMatcher):

* candidates: the dense descriptor distance matrix and each feature's
  n + 1 nearest neighbours (FLANN kNN in the reference), with the NNDR
  shortlist test;
* payoff: the pairwise affine-consistency payoff of every two candidates,
  one (C, C) matrix per frame;
* rounds: iidyn (match/iidyn.py, the CUDA kernel on a card) selects a
  mutually consistent group; its candidates win, and every candidate that
  shares a winner's source or target leaves the game; repeat.

Fixed shapes: K features an image, C = K * n_candidates associations,
masks throughout.  The nearest neighbours come from a stable sort of the
distances, so ties take the lowest index, as lax.top_k does.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from wass_tpu_torch.match.features import FeatureSet
from wass_tpu_torch.match.iidyn import iidyn, initial_population


class Candidates(NamedTuple):
    src: torch.Tensor  # (C,) int64 index into feature set A
    dst: torch.Tensor  # (C,) int64 index into feature set B
    valid: torch.Tensor  # (C,) bool
    nndr_best: torch.Tensor  # (C,) bool: passed the NNDR shortlist test


class MatchResult(NamedTuple):
    src: torch.Tensor  # (C,) indices into A
    dst: torch.Tensor  # (C,) indices into B
    valid: torch.Tensor  # (C,) bool: candidate i is a match
    n_rounds: int


def generate_candidates(fa: FeatureSet, fb: FeatureSet, n_per_feature: int = 3, nndr: float = 0.25) -> Candidates:
    """kNN candidates from the distance matrix (GTMatcher.cpp:180-216)."""
    K = fa.desc.shape[0]
    dev = fa.desc.device
    d2 = (fa.desc**2).sum(-1, keepdim=True) + (fb.desc**2).sum(-1)[None, :] - 2.0 * fa.desc @ fb.desc.T
    d2 = torch.where(fa.valid[:, None] & fb.valid[None, :], d2, 1e10)
    near, idx = torch.sort(d2, dim=1, stable=True)
    near, idx = near[:, : n_per_feature + 1], idx[:, : n_per_feature + 1]
    dist = torch.sqrt(torch.clamp_min(near, 0.0))
    nndr_ok = dist[:, 0] < nndr * dist[:, 1]  # best << second best (GTMatcher.cpp:197)

    src = torch.arange(K, device=dev).repeat_interleave(n_per_feature)
    dst = idx[:, :n_per_feature].reshape(-1)
    valid = fa.valid.repeat_interleave(n_per_feature) & (dist[:, :n_per_feature].reshape(-1) < 1e4)
    first_of_feature = torch.arange(K * n_per_feature, device=dev) % n_per_feature == 0
    nndr_best = nndr_ok.repeat_interleave(n_per_feature) & first_of_feature
    return Candidates(src, dst, valid, nndr_best)


def _affine_params(fa: FeatureSet, fb: FeatureSet, cand: Candidates):
    """Per-candidate similarity transform (association::compute_affine,
    GTMatcher.cpp:69-97): rotation by the angle difference, the scale
    ratio, and the translation that maps the source feature onto the
    target."""
    a = fb.angle[cand.dst]
    b = fa.angle[cand.src]
    diff = torch.remainder(b - a + math.pi, 2 * math.pi) - math.pi  # ang_diff (:47-52)
    cos_a = torch.cos(diff)
    sin_a = torch.sin(diff)
    dscale = fb.scale[cand.dst] / torch.clamp_min(fa.scale[cand.src], 1e-12)
    sx = fa.xy[cand.src, 0] * dscale
    sy = fa.xy[cand.src, 1] * dscale
    rx = sx * cos_a - sy * sin_a
    ry = sx * sin_a + sy * cos_a
    return cos_a, sin_a, dscale, fb.xy[cand.dst, 0] - rx, fb.xy[cand.dst, 1] - ry


def payoff_matrix(fa: FeatureSet, fb: FeatureSet, cand: Candidates, lam: float = 1e-5) -> torch.Tensor:
    """(C, C) payoff exp(-lambda * symmetric affine-transfer error)
    (GTMatcher.cpp:101-141); zero for candidates sharing a source or a
    target (one-to-one) and for invalid candidates, and on the diagonal."""
    cos_a, sin_a, ds, dx, dy = (t[:, None] for t in _affine_params(fa, fb, cand))
    sxy = fa.xy[cand.src]
    txy = fb.xy[cand.dst]
    sx_j, sy_j, tx_j, ty_j = sxy[None, :, 0], sxy[None, :, 1], txy[None, :, 0], txy[None, :, 1]
    # Candidate i's transform applied to candidate j's source feature.
    ex = tx_j - (ds * (sx_j * cos_a - sy_j * sin_a) + dx)
    ey = ty_j - (ds * (sx_j * sin_a + sy_j * cos_a) + dy)
    e = ex * ex + ey * ey
    del ex, ey
    pay = torch.exp(-lam * torch.maximum(e, e.T))  # symmetric max (geometric_error :101-124)
    del e
    ok = cand.valid[:, None] & cand.valid[None, :]
    ok &= cand.src[:, None] != cand.src[None, :]
    ok &= cand.dst[:, None] != cand.dst[None, :]  # also clears the diagonal
    return torch.where(ok, pay, 0.0)


def gt_match(fa: FeatureSet, fb: FeatureSet, cand: Candidates, pay: torch.Tensor, uniforms: torch.Tensor,
             pop_threshold: float = 0.7, max_rounds: int = 20, min_group_size: int = 5,
             iidyn_iters: int = 20000) -> MatchResult:
    """Up to max_rounds match-group extractions (wass_match.cpp:218-239).

    uniforms: (max_rounds, C) draws in [0, 1); round r starts iidyn from
    initial_population(uniforms[r]).  The host reads the round's group size
    and the live count once per round.  Candidate i is a match iff
    valid[i] of the result."""
    C = pay.shape[0]
    K = fa.xy.shape[0]
    Kb = fb.xy.shape[0]
    live = cand.valid
    winners = torch.zeros(C, dtype=torch.bool, device=pay.device)
    rnd, go, n_live = 0, True, int(live.sum())
    while go and rnd < max_rounds and n_live > 0:
        x0 = initial_population(uniforms[rnd], live)
        x, _, _ = iidyn(pay, x0, mask=live, max_iters=iidyn_iters)
        group = (x > x.max() * pop_threshold) & live
        # Remove the candidates that share a winning source or target
        # (GTMatcher.cpp:300-315): a table of the winners' indices.
        hit_src = torch.zeros(K + 1, dtype=torch.bool, device=pay.device)
        hit_src[torch.where(group, cand.src, K)] = True
        hit_dst = torch.zeros(Kb + 1, dtype=torch.bool, device=pay.device)
        hit_dst[torch.where(group, cand.dst, Kb)] = True
        live = live & ~(hit_src[:K][cand.src] | hit_dst[:Kb][cand.dst])
        winners = winners | group
        gsize, n_live = torch.stack([group.sum(), live.sum()]).tolist()
        go = gsize >= min_group_size
        rnd += 1
    return MatchResult(src=cand.src, dst=cand.dst, valid=winners, n_rounds=rnd)


def nearest_match(cand: Candidates) -> MatchResult:
    """MATCHER_SKIP_GT (wass_match.cpp:44,300-304): the NNDR winners only."""
    return MatchResult(src=cand.src, dst=cand.dst, valid=cand.nndr_best & cand.valid, n_rounds=0)
