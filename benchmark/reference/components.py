"""Reference copy of wass_tpu_torch/ops/components.py and ops/components_kernels.py (the plain propagation), frozen when the
benchmark was written: plain PyTorch and NumPy, importing nothing of the
program; where the program launches a CUDA kernel this copy runs the
kernel's plain version.  The original's notes follow.

Connected-component labels by min-label propagation.

Counterpart of wass_tpu/ops/components.py.  Every valid pixel starts with
its linear index; labels propagate across valid, gated 4-neighbour edges
(kernel K7, ops/components_kernels.py), so each component ends labelled
with its smallest linear index and invalid pixels with INT32_MAX.  The
propagation runs 2 * max_iters rounds of min(fwd, bwd) passes, as the
reference's TPU kernel does (components_pallas.py); converged, it gives the
reference's labels.
"""

from __future__ import annotations

from typing import Optional

import torch


INT32_MAX = 2**31 - 1


def label_components(
    valid: torch.Tensor,
    edge_h: Optional[torch.Tensor] = None,
    edge_v: Optional[torch.Tensor] = None,
    max_iters: int = 12,
) -> torch.Tensor:
    """Label the 4-connected components of a (H, W) bool mask.

    edge_h (H, W-1): edge (y, x)-(y, x+1) traversable; edge_v (H-1, W):
    edge (y, x)-(y+1, x) traversable.  Returns (H, W) int32 labels."""
    H, W = valid.shape
    dev = valid.device
    idx = torch.arange(H * W, dtype=torch.int32, device=dev).reshape(H, W)
    init = torch.where(valid, idx, INT32_MAX)
    if edge_h is None:
        edge_h = torch.ones((H, W - 1), dtype=torch.bool, device=dev)
    if edge_v is None:
        edge_v = torch.ones((H - 1, W), dtype=torch.bool, device=dev)
    conn_v = torch.cat(
        [torch.zeros((1, W), dtype=torch.bool, device=dev), edge_v & valid[:-1] & valid[1:]], 0
    ).to(torch.uint8)
    conn_h = torch.cat(
        [torch.zeros((H, 1), dtype=torch.bool, device=dev), edge_h & valid[:, :-1] & valid[:, 1:]], 1
    ).to(torch.uint8)
    labels = propagate_labels_plain(init, conn_v, conn_h, 2 * max_iters)
    return torch.where(valid, labels, INT32_MAX)


def _modal_label(labels: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Label of the largest component, a 0-dim int32 tensor on the labels'
    device (no host read): a histogram of the valid labels, which are
    linear indices of the grid, by one index_add_, then its first maximum
    (torch.max along a dimension, whose index a 0-dim tensor would read on
    the host), so ties go to the smallest label; INT32_MAX when nothing is
    valid.
    Above 2^20 pixels the vote runs on a stride-4 sample, as the reference."""
    n = labels.numel()
    if n > (1 << 20):
        labels = labels[::4, ::4]
        valid = valid[::4, ::4]
    bins = torch.where(valid, labels, n).reshape(-1).to(torch.int64)  # invalid pixels go to bin n
    hist = torch.zeros(n + 1, dtype=torch.int32, device=labels.device)
    hist.index_add_(0, bins, torch.ones_like(bins, dtype=torch.int32))
    count, best = torch.max(hist[:n], 0)  # the first maximum; no host read
    return torch.where(count > 0, best.to(torch.int32), INT32_MAX)


def biggest_component_mask(
    valid: torch.Tensor,
    edge_h: Optional[torch.Tensor] = None,
    edge_v: Optional[torch.Tensor] = None,
    max_iters: int = 12,
) -> torch.Tensor:
    """Mask of the largest connected component of `valid`."""
    labels = label_components(valid, edge_h, edge_v, max_iters)
    return (labels == _modal_label(labels, valid)) & valid


def zgap_component_mask(
    z: torch.Tensor, valid: torch.Tensor, max_zgap, max_iters: int = 12
) -> torch.Tensor:
    """Largest component where 4-neighbours connect only if |dz| < max_zgap
    (PovMesh::cluster_biggest_connected_component's edge criterion)."""
    edge_h = (z[:, :-1] - z[:, 1:]).abs() < max_zgap
    edge_v = (z[:-1, :] - z[1:, :]).abs() < max_zgap
    return biggest_component_mask(valid, edge_h, edge_v, max_iters)


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
