"""Wrapper of the label-propagation CUDA kernel K7 and its plain version.

Counterpart of wass_tpu/ops/components_pallas.py (label_components_pallas,
csrc/components.cu).  One round is a vertical then a horizontal pass;
each pass takes, along every column (row), the segmented running minimum
of the labels walking forward and walking backward, and keeps
min(fwd, bwd).  `propagate_labels` launches the kernel for CUDA tensors
and runs `propagate_labels_plain` for CPU tensors only.

The kernel stops early where stopping is exact: a round that changes no
label is a fixed point, so the launches after it return at once (device
flags; the host reads none on the main path).  `rounds_changed` reads,
after a synchronize, how many rounds of the last launch changed labels.
"""

from __future__ import annotations

import torch

from wass_tpu_torch import _build
from wass_tpu_torch.device import on_cuda
from wass_tpu_torch.instrument import LaunchCounts

LAUNCHES = LaunchCounts({"label_propagate": 0})
# The per-round change flags of the last kernel launch (int32, one a round).
LAST_CHANGED = None


def _seg_min_scan(lab: torch.Tensor, conn: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive segmented running min along dim, forward.  conn[i] means
    element i joins element i - 1.  Hillis-Steele doubling: each step
    combines every element with the partial result `k` places back."""
    n = lab.shape[dim]
    k = 1
    while k < n:
        l_prev, c_prev = lab.narrow(dim, 0, n - k), conn.narrow(dim, 0, n - k)
        l_cur, c_cur = lab.narrow(dim, k, n - k), conn.narrow(dim, k, n - k)
        lab = torch.cat([lab.narrow(dim, 0, k), torch.where(c_cur, torch.minimum(l_prev, l_cur), l_cur)], dim)
        conn = torch.cat([conn.narrow(dim, 0, k), c_prev & c_cur], dim)
        k *= 2
    return lab


def _propagate_pass(lab: torch.Tensor, conn: torch.Tensor, dim: int) -> torch.Tensor:
    fwd = _seg_min_scan(lab, conn, dim)
    # Backward walk: element i joins i + 1 through conn[i + 1].
    n = lab.shape[dim]
    conn_next = torch.cat([conn.narrow(dim, 1, n - 1), torch.zeros_like(conn.narrow(dim, 0, 1))], dim)
    bwd = _seg_min_scan(lab.flip(dim), conn_next.flip(dim), dim).flip(dim)
    return torch.minimum(fwd, bwd)


def propagate_labels_plain(
    labels: torch.Tensor, conn_v: torch.Tensor, conn_h: torch.Tensor, rounds: int
) -> torch.Tensor:
    cv = conn_v != 0
    ch = conn_h != 0
    for _ in range(rounds):
        labels = _propagate_pass(labels, cv, 0)
        labels = _propagate_pass(labels, ch, 1)
    return labels


def propagate_labels(
    labels: torch.Tensor, conn_v: torch.Tensor, conn_h: torch.Tensor, rounds: int
) -> torch.Tensor:
    """K7: (H, W) int32 initial labels + uint8 connectivity -> (H, W) int32
    labels after `rounds` rounds.  conn_v[y, x]: (y, x) joins (y-1, x);
    conn_h[y, x]: (y, x) joins (y, x-1)."""
    if not on_cuda(labels, conn_v, conn_h):
        return propagate_labels_plain(labels, conn_v, conn_h, rounds)
    if labels.dim() != 2 or conn_v.shape != labels.shape or conn_h.shape != labels.shape:
        raise ValueError("labels, conn_v and conn_h must share one (H, W) shape")
    if labels.dtype != torch.int32 or conn_v.dtype != torch.uint8 or conn_h.dtype != torch.uint8:
        raise ValueError("labels must be int32 and the connectivity uint8")
    if not (conn_v.is_contiguous() and conn_h.is_contiguous()):
        raise ValueError("connectivity must be contiguous")
    global LAST_CHANGED
    H, W = labels.shape
    out = labels.contiguous().clone()
    changed = torch.zeros(max(rounds, 1), dtype=torch.int32, device=labels.device)
    _build.launch("wass_label_propagate", "label_propagate kernel", labels.device,
                  out.data_ptr(), conn_v.data_ptr(), conn_h.data_ptr(), changed.data_ptr(),
                  H, W, rounds)
    LAUNCHES.add("label_propagate")
    LAST_CHANGED = changed[:rounds]
    return out


def rounds_changed() -> int:
    """Rounds of the last kernel launch that changed a label (a host read:
    call it after the launch, off the main path)."""
    if LAST_CHANGED is None:
        raise RuntimeError("no label_propagate kernel has run")
    return int(LAST_CHANGED.sum())
