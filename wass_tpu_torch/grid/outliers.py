"""Local-plane outlier voting for aligned point clouds, on torch tensors.

Counterpart of wass_tpu/grid/outliers.py, the JAX package's re-design of
the reference's filter_mesh_outliers
(gridding/wassgridsurface/wass_utils.py:72-163): points
are binned into a 15x15 grid of cells, each cell gets a robust local
plane from 3 rounds of iteratively-reweighted least squares (fit -> mask
points beyond the inlier threshold -> refit), computed for all cells at
once from per-cell moment sums, and a point is voted out when it exceeds
the threshold against its own cell's plane.  The per-cell 3x3 normal
equations are one batched solve written out as the partially pivoted LU
that jnp.linalg.solve runs (`solve3`), so that a cell whose system is
singular to float32 gets non-finite coefficients and keeps its points, as
in the JAX package.

The segment sums (each cell's moments) are taken in an order fixed by
the data alone, so the votes are the same on every run:
* on the CPU, index_add_, which adds the points in index order (the order
  that holds the votes bit-equal to XLA's);
* on the card, where index_add_ adds with atomics in no fixed order, the
  points are sorted by cell once (a stable sort, shared by the three IRLS
  rounds and the final count) and summed level by level: each cell's run
  of points is cut into rows of SUM_CHUNK (the last one padded with
  zeros), a fixed-shape torch.sum adds each row, and the rows of a cell
  are cut and summed again until one is left (`segment_plan`,
  `segment_sums`).  The shapes, and so the order of every addition,
  follow from the cells' point counts.  The card's sums differ from the
  CPU's in their last bits, so a few votes near the threshold may differ
  between the two.
"""

from __future__ import annotations

import torch

N_CELLS = 15  # reference scan grid (wass_utils.py:134)
SUM_CHUNK = 256  # the rows of the card's fixed-order segment sums


def solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 solve A x = b, (n, 3, 3) and (n, 3) -> (n, 3), by LU with
    partial pivoting in LAPACK getrf's order: the first row of largest
    |pivot|, the column below it scaled by the pivot's reciprocal, a zero
    pivot left unscaled; then the unit lower and the upper triangular
    solves.  A pivot that vanishes in float32 gives inf or NaN, where
    torch.linalg.solve (and its tiny pivot) stays finite."""
    A = A.clone()
    x = b.clone()
    rows = torch.arange(A.shape[0], device=A.device)
    for k in range(3):
        p = k + torch.argmax(A[:, k:, k].abs(), dim=1)  # the first of equal maxima, as isamax
        for t in (A, x):
            rk, rp = t[rows, k].clone(), t[rows, p].clone()
            t[rows, k], t[rows, p] = rp, rk
        piv = A[:, k, k]
        recip = torch.where(piv != 0, 1.0 / piv, torch.zeros_like(piv))
        for i in range(k + 1, 3):
            lik = A[:, i, k] * recip
            A[:, i, k] = lik
            for j in range(k + 1, 3):
                A[:, i, j] = A[:, i, j] - lik * A[:, k, j]
    for i in range(1, 3):  # L y = P b, L unit lower
        for j in range(i):
            x[:, i] = x[:, i] - A[:, i, j] * x[:, j]
    for i in (2, 1, 0):  # U x = y, the later unknowns first (trsm's column order)
        for j in range(2, i, -1):
            x[:, i] = x[:, i] - A[:, i, j] * x[:, j]
        x[:, i] = x[:, i] / A[:, i, i]
    return x


def segment_plan(cell: torch.Tensor, n_seg: int):
    """The fixed order of `segment_sums` for points in cells `cell` (N,)
    int64: (the stable sort of the points by cell, the levels, the cells
    that hold points).  A level is (slots, rows): its elements' places in a
    (rows, SUM_CHUNK) table whose rows each hold part of one cell's run, in
    order.  One host read a level."""
    order = torch.argsort(cell, stable=True)
    counts = torch.bincount(cell, minlength=n_seg)
    seg = cell[order]
    ids = torch.arange(n_seg, device=cell.device)
    levels = []
    while seg.numel() and int(counts.max()) > 1:
        rows = (counts + SUM_CHUNK - 1) // SUM_CHUNK
        start, row0 = torch.cumsum(counts, 0) - counts, torch.cumsum(rows, 0) - rows
        slots = row0[seg] * SUM_CHUNK + torch.arange(seg.numel(), device=cell.device) - start[seg]
        n_rows = int(rows.sum())
        levels.append((slots, n_rows))
        seg = torch.repeat_interleave(ids, rows, output_size=n_rows)
        counts = rows
    return order, levels, counts > 0


def segment_sums(v: torch.Tensor, plan) -> torch.Tensor:
    """Each cell's sums of the columns of v (N, k), in the plan's order ->
    (n_seg, k); 0 for a cell without points."""
    order, levels, held = plan
    x = v[order]
    for slots, n_rows in levels:
        table = torch.zeros((n_rows * SUM_CHUNK, v.shape[1]), dtype=v.dtype, device=v.device)
        table[slots] = x
        x = table.view(n_rows, SUM_CHUNK, v.shape[1]).sum(1)
    out = torch.zeros((held.shape[0], v.shape[1]), dtype=v.dtype, device=v.device)
    out[held] = x
    return out


def _vote_device(pts: torch.Tensor, threshold: float, n_cells: int = N_CELLS, irls_rounds: int = 3,
                 fixed_order=None) -> torch.Tensor:
    """pts: (N, 3) float32 aligned points -> (N,) bool keep mask.  The
    segment sums go through `segment_sums` when fixed_order (by default on
    the card), through index_add_ otherwise."""
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    xmin, xmax = x.min(), x.max()
    ymin, ymax = y.min(), y.max()
    cx = torch.clamp(((x - xmin) / torch.clamp_min(xmax - xmin, 1e-9) * n_cells).to(torch.int32), 0, n_cells - 1)
    cy = torch.clamp(((y - ymin) / torch.clamp_min(ymax - ymin, 1e-9) * n_cells).to(torch.int32), 0, n_cells - 1)
    cell = (cy * n_cells + cx).long()
    n_seg = n_cells * n_cells
    if fixed_order is None:
        fixed_order = pts.is_cuda
    if fixed_order:
        plan = segment_plan(cell, n_seg)

        def seg(*vs):
            return segment_sums(torch.stack(vs, 1), plan).unbind(1)
    else:
        def seg(*vs):
            return [torch.zeros(n_seg, dtype=v.dtype, device=v.device).index_add_(0, cell, v) for v in vs]

    w = torch.ones_like(z)
    eye = torch.eye(3, dtype=z.dtype, device=z.device) * 1e-6
    dist = torch.zeros_like(z)
    for _ in range(irls_rounds):
        # Weighted plane z = a x + b y + c per cell: normal equations from
        # the per-cell moment sums (a 3x3 solve per cell).
        sw, sx, sy, sz, sxx, sxy, syy, sxz, syz = seg(w, w * x, w * y, w * z, w * x * x, w * x * y, w * y * y,
                                                      w * x * z, w * y * z)
        A = torch.stack(
            [
                torch.stack([sxx, sxy, sx], -1),
                torch.stack([sxy, syy, sy], -1),
                torch.stack([sx, sy, sw], -1),
            ],
            -2,
        )
        b = torch.stack([sxz, syz, sz], -1)
        abc = solve3(A + eye, b)  # (n_seg, 3)
        a_p, b_p, c_p = abc[cell, 0], abc[cell, 1], abc[cell, 2]
        denom = torch.sqrt(a_p**2 + b_p**2 + 1.0)
        dist = torch.abs(a_p * x + b_p * y + c_p - z) / denom
        w = (dist < threshold).to(z.dtype)

    # Degenerate cells (fewer than 4 surviving points) keep everything.
    (sw,) = seg(w)
    enough = sw >= 4
    return (dist < threshold) | ~enough[cell]


def filter_mesh_outliers(mesh_aligned: torch.Tensor, ransac_inlier_threshold: float = 0.2) -> torch.Tensor:
    """mesh_aligned: (3, N) sea-plane-aligned points (meters).  Returns the
    filtered (3, M) cloud, like the reference function."""
    if mesh_aligned.shape[1] < 16:
        return mesh_aligned
    keep = _vote_device(mesh_aligned.T.float().contiguous(), ransac_inlier_threshold)
    return mesh_aligned[:, keep]
