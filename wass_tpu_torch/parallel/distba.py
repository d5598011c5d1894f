"""Point-sharded Schur-complement bundle adjustment over a frame mesh.

Counterpart of wass_tpu/parallel/distba.py.  The pooled point blocks are
split over the mesh's slots: each slot computes its points' Jacobians, 3x3
block inverses and Schur terms on its own device, and only the reduced
camera system (the 6x6 Schur complement, its right-hand side and the
cost; ~340 bytes a step in float32) is summed: over the process's slots
in slot order on its first slot's device, then across ranks with
torch.distributed.all_reduce (calib/ba.py:lm_refine_two_view's shards
and reduce).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from wass_tpu_torch.calib.ba import BAResult, lm_refine_two_view
from wass_tpu_torch.parallel.mesh import Slot, all_reduce_sum, local_frame_indices


def lm_refine_two_view_sharded(mesh: Sequence[Slot], R_init, T_init, X_init, p0, p1, mask,
                               max_iters: int = 50) -> BAResult:
    """Point-sharded LM over `mesh`.  The per-point arrays (X_init, p0, p1,
    mask; numpy or tensors) hold the points of this process's slots, split
    into equal consecutive blocks, one a slot in mesh order: every point in
    one process, the rank's own rows under a process group (pad with
    pad_points_for_mesh, mask False).  R_init and T_init go to the first
    local slot's device, where the result's R, T and costs lie; its X is
    the local points, in order, on that device.

    A masked row takes no part, but its numbers still flow through the
    products (times 0): a zero pad row would put 0/0 in them, so masked
    rows enter as the point (0, 0, 1) seen at (0, 0), and come back so."""
    local = [mesh[k].device for k in local_frame_indices(mesh)]
    n = len(mask)
    if n % len(local):
        raise ValueError(f"{n} points do not split over {len(local)} local slots: pad them (pad_points_for_mesh)")
    rows = n // len(local)
    dev0 = local[0]

    def shards(t):
        return [t[i * rows:(i + 1) * rows].to(d) for i, d in enumerate(local)]

    m = torch.as_tensor(mask).to(torch.bool)
    X = torch.as_tensor(X_init)
    X = torch.where(m[:, None], X, torch.tensor([0.0, 0.0, 1.0], dtype=X.dtype))
    p0, p1 = (torch.where(m[:, None], torch.as_tensor(p), 0.0) for p in (p0, p1))
    res = lm_refine_two_view(torch.as_tensor(R_init).to(dev0), torch.as_tensor(T_init).to(dev0),
                             shards(X), shards(p0), shards(p1), shards(m), max_iters=max_iters,
                             reduce=all_reduce_sum)
    return res._replace(X=torch.cat([x.to(dev0) for x in res.X]))


def pad_points_for_mesh(arrs, mask, n_dev: int):
    """Pad leading axes to a multiple of n_dev; extend mask with False."""
    N = mask.shape[0]
    pad = (-N) % n_dev
    if pad == 0:
        return arrs, mask
    out = [np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)]) for a in arrs]
    m = np.concatenate([mask, np.zeros(pad, bool)])
    return out, m
