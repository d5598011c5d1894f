"""Out-of-core streaming over gridded cubes, under a memory budget.

Counterpart of wass_tpu/post/ooc.py over the port's HDF5 datasets
(wass_tpu_torch/io/hdf5.py, no h5py).  Hour-long cubes (a 20 Hz x 30 min
x 512^2 float32 cube is ~38 GB) are never loaded whole: time-axis
operators stream spatial column blocks (T, by, bx) that carry the full
time series of each point (the reference's filter_fast chunking,
wasspost.py:157-251), frame-wise operators stream time slabs (bt, H, W),
each sized so that n_buffers copies fit the budget (WASS_POST_MEMORY_MB,
default 512; the tests set it tiny to run the streaming paths).  A
dataset reads and writes only what it selects (np.memmap over its
contiguous data).
"""

from __future__ import annotations

import os
from typing import Callable, Iterator, Tuple

import numpy as np


def memory_budget_bytes() -> int:
    mb = float(os.environ.get("WASS_POST_MEMORY_MB", "512"))
    return int(mb * 1024 * 1024)


def iter_col_blocks(shape, itemsize: int, n_buffers: int = 3) -> Iterator[Tuple[slice, slice]]:
    """Spatial blocks (full time axis): yields (ys, xs) such that
    n_buffers copies of (T, by, bx) fit the budget."""
    T, H, W = shape
    per_col = max(T * itemsize * n_buffers, 1)
    cols = max(memory_budget_bytes() // per_col, 1)
    # Full-width row bands; column tiles of one row when a row does not fit.
    by = max(min(int(cols // W), H), 1)
    bx = W if cols >= W else max(int(cols), 1)
    if cols < W:
        by = 1
    for y0 in range(0, H, by):
        ys = slice(y0, min(y0 + by, H))
        for x0 in range(0, W, bx):
            yield ys, slice(x0, min(x0 + bx, W))


def iter_time_slabs(shape, itemsize: int, n_buffers: int = 3) -> Iterator[slice]:
    """Time slabs (full spatial extent): yields slices such that n_buffers
    copies of (bt, H, W) fit the budget."""
    T, H, W = shape
    per_frame = max(H * W * itemsize * n_buffers, 1)
    bt = max(min(memory_budget_bytes() // per_frame, T), 1)
    for t0 in range(0, T, bt):
        yield slice(t0, min(t0 + bt, T))


def make_like(f, src, name: str, dtype=None):
    """A new contiguous dataset `name` of src's shape (replacing one of
    that name), in the file f opened "r+"."""
    if name in f:
        del f[name]
    return f.create_dataset(name, src.shape, dtype or src.dtype)


def apply_timewise(f, src_name: str, dst_name: str, fn: Callable, dtype=None):
    """dst[:, ys, xs] = fn(src[:, ys, xs]) over spatial blocks, the full
    time axis in each block ('crucial to chunk count = -1',
    wasspost.py:189-191); in place when src_name == dst_name."""
    src = f[src_name]
    dst = src if src_name == dst_name else make_like(f, src, dst_name, dtype)
    for ys, xs in iter_col_blocks(src.shape, src.dtype.itemsize):
        dst[:, ys, xs] = fn(src[:, ys, xs])
    return dst


def apply_framewise(f, src_name: str, dst_name: str, fn: Callable, dtype=None):
    """dst[ts] = fn(src[ts]) over time slabs; in place when src_name == dst_name."""
    src = f[src_name]
    dst = src if src_name == dst_name else make_like(f, src, dst_name, dtype)
    for ts in iter_time_slabs(src.shape, src.dtype.itemsize):
        dst[ts] = fn(src[ts])
    return dst


def streaming_time_mean(dset) -> np.ndarray:
    """NaN-aware per-point temporal mean in float64, accumulated over time
    slabs (the first pass of the chunked zeromean, wasspost.py:965-1005)."""
    T, H, W = dset.shape
    s = np.zeros((H, W), np.float64)
    n = np.zeros((H, W), np.int64)
    for ts in iter_time_slabs(dset.shape, dset.dtype.itemsize):
        x = np.asarray(dset[ts], np.float64)
        m = np.isfinite(x)
        s += np.where(m, x, 0.0).sum(axis=0)
        n += m.sum(axis=0)
    return s / np.maximum(n, 1)
