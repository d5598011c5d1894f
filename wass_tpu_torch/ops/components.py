"""Connected-component labels by min-label propagation.

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

from wass_tpu_torch.ops.components_kernels import propagate_labels

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
    inf = torch.tensor(INT32_MAX, dtype=torch.int32, device=dev)
    init = torch.where(valid, idx, inf)
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
    labels = propagate_labels(init, conn_v, conn_h, 2 * max_iters)
    return torch.where(valid, labels, inf)


def _modal_label(labels: torch.Tensor, valid: torch.Tensor) -> int:
    """Label of the largest component; ties go to the smallest label.
    Above 2^20 pixels the vote runs on a stride-4 sample, as the reference."""
    if labels.numel() > (1 << 20):
        labels = labels[::4, ::4]
        valid = valid[::4, ::4]
    flat = labels[valid]
    if flat.numel() == 0:
        return INT32_MAX
    values, counts = torch.unique_consecutive(torch.sort(flat).values, return_counts=True)
    return int(values[torch.argmax(counts)])


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
