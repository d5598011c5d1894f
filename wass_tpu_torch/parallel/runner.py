"""Frame-sharded dense runner: a batch of stereo frames over a frame mesh,
one frame a slot.

Counterpart of wass_tpu/parallel/runner.py.  The JAX package runs one SPMD
program over a ("frame",) mesh; here each process dispatches the frames of
its own slots (mesh.local_frame_indices), each on its slot's device from a
thread of its own, so the devices compute at once.  A frame runs the
JAX shard's per-frame pipeline (_frame_pipeline): the coarse pass (K1 +
K3), the row windows, the full-resolution census and K2, K6 at the
config's path count and the plain windowed WTA, then the postprocess,
triangulation, z-gap outliers (K7) and the plane.  The pipelined loop's
fused K4 does not run here, as in the JAX package.

The c2f safety net is the JAX runner's: every frame's coverage and
off-band scalars are read (and gathered across ranks), and only the
frames that trip the guard re-run, each as a single full-range frame on
its owner's device, their results swapped into the per-slot lists (the
counterpart of replace_frame_shard).  The planes, 4 floats a frame, are
gathered on the host from every rank, as multihost_utils.process_allgather
does, and the mean plane is their nanmean.  The slot threads work for the
caller's thread: their spans (instrument.py) and their device reads count
in the caller's recorder, under the caller's frame (the batch's index).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from wass_tpu_torch.instrument import current, frame_scope, host_read, span
from wass_tpu_torch.parallel.mesh import Slot, all_gather_host, local_frame_indices
from wass_tpu_torch.stereo import sgm_kernels
from wass_tpu_torch.stereo.c2f import TILE_ROWS, coarse_disparity, compute_row_windows, wta_disparity_windowed
from wass_tpu_torch.stereo.dense import (
    DenseFrameResult,
    DenseStereoConfig,
    DenseStereoPipeline,
    _c2f_active,
    c2f_should_fallback,
    disparity_postprocess,
    outlier_removal,
    plane_stage,
    rectify_on_device,
    triangulate_dense,
)


def device_scope(device: torch.device):
    """`device` as the current CUDA device (a no-op for the CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _frame_pipeline(bi, mi, gp, cfg: DenseStereoConfig, rectified: bool, uv=None):
    """One frame on the device of its tensors (the JAX shard's unbatched
    pipeline).  Returns (DenseFrameResult, (base_rect, match_rect),
    (coverage, offband)), the last two 0-d tensors, 1 and 0 when c2f is
    inactive.  uv: optional RANSAC pixel picks."""
    H, W = bi.shape
    if rectified:
        br, mr = bi, mi
    else:
        with span("loop.rectify"):
            br = rectify_on_device(bi, gp["H_base"], (H, W))
            mr = rectify_on_device(mi, gp["H_match"], (H, W))
    with span("dense.frame"):
        if _c2f_active(cfg, br.shape):
            with span("dense.disparity"):
                disp_c = coarse_disparity(br, mr, cfg.num_disp, cfg.min_disp, cfg.p1, cfg.p2, cfg.directions,
                                          cfg.census_win, cfg.uniqueness_ratio, cfg.c2f_factor)
                wstart, cov, offb = compute_row_windows(disp_c, cfg.c2f_factor, cfg.num_disp, cfg.min_disp,
                                                        cfg.c2f_window)
            with span("dense.census"):
                cb = sgm_kernels.census_transform(br, cfg.census_win, cfg.input_smooth_sigma)
                cm = sgm_kernels.census_transform(mr, cfg.census_win, cfg.input_smooth_sigma)
            with span("dense.disparity"):
                cost = sgm_kernels.census_cost_volume_windowed(cb, cm, wstart, cfg.c2f_window)
                agg = sgm_kernels.sgm_aggregate_windowed(cost, wstart, cfg.p1, cfg.p2, cfg.directions)
                disp = wta_disparity_windowed(agg, wstart.repeat_interleave(TILE_ROWS), cfg.uniqueness_ratio)
            with span("dense.post"):
                disp = disparity_postprocess(disp, cfg)
        else:
            disp = DenseStereoPipeline(cfg).disparity(br, mr)
            cov = torch.ones((), dtype=torch.float32, device=br.device)
            offb = torch.zeros((), dtype=torch.float32, device=br.device)
        with span("dense.post"):
            pts, valid, reasons = triangulate_dense(disp, gp, br, mr, cfg)
            keep, _ = outlier_removal(pts, valid, cfg)
        with span("dense.plane"):
            plane, ok, valid = plane_stage(pts, valid & keep, cfg, uv)
    res = DenseFrameResult(points=pts, valid=valid, plane=plane, plane_ok=ok, disparity=disp, n_points=valid.sum(),
                           fail_reasons=reasons)
    return res, (br, mr), (cov, offb)


def _on(x, device: torch.device) -> torch.Tensor:
    """A frame image (numpy or tensor) as float32 on `device`."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    return t.to(device).to(torch.float32)


def pack_on(gp: dict, device: torch.device) -> dict:
    """A geometry pack (stereo/dense.build_geom_pack) with its tensors on
    `device`."""
    return {k: v.to(device) if isinstance(v, torch.Tensor) else v for k, v in gp.items()}


class ShardedDenseRunner:
    """Runs batches of frame pairs over the frame mesh, one frame a slot.

    Each frame carries its own geometry pack.  Each process passes the
    frames of its own slots (local_frame_indices; all of them in one
    process).  n_fallback_reruns counts the single-frame full-range
    re-runs this runner made (the tests check the fallback's granularity
    through it).  uv: optional RANSAC pixel picks for every frame (tests)."""

    def __init__(self, mesh: Sequence[Slot], cfg: DenseStereoConfig, uv=None):
        self.mesh = list(mesh)
        # An unresolved AUTO (negative) input_smooth_sigma flows through:
        # the census level maps it to the clean-input baseline (0.8).
        self.cfg = cfg
        self.cfg_full = dataclasses.replace(cfg, c2f_window=0)
        self.uv = uv
        self.local = local_frame_indices(self.mesh)
        self.n_fallback_reruns = 0

    def _run_slot(self, j: int, bi, mi, gp, cfg, rectified: bool, launches: dict, caller=None):
        """Slot j's frame; its launches count in `launches`, its spans and
        reads in the recorder of the caller's scope (`caller`), as the
        dispatching thread's."""
        dev = self.mesh[self.local[j]].device
        index, recorder = (caller.index, caller.recorder) if caller is not None else (0, None)
        with device_scope(dev), frame_scope(launches, index, recorder, dispatching=True):
            bi, mi, gp = _on(bi, dev), _on(mi, dev), pack_on(gp, dev)
            res, rects, diag = _frame_pipeline(bi, mi, gp, cfg, rectified, self.uv)
            # The frame's host read of its c2f scalars.
            diag = tuple(host_read(torch.stack(diag), "runner.c2f_read").tolist())
        return res, rects, diag, (bi, mi, gp)

    def run_batch(self, base_img: Sequence, match_img: Sequence, geom_packs: Sequence[dict],
                  rectified: bool = False):
        """base_img / match_img: the base- and match-role images of this
        process's slots (undistorted, or rectified when rectified=True;
        numpy or tensors, (H, W) each); geom_packs: one pack each.
        Returns (per-slot DenseFrameResults, per-slot (base_rect,
        match_rect), info, mean plane (4,) float64 numpy).  info holds the
        global slots' c2f "coverage" and "offband" (None when c2f is
        inactive), "fallback_frames" (global slots re-run at full range),
        "planes" (F, 4), "plane_ok" and "n_points" of every slot, and this
        process's per-slot kernel "launches"."""
        n_local = len(self.local)
        if not (len(base_img) == len(match_img) == len(geom_packs) == n_local):
            raise ValueError(f"a batch holds one frame a slot: pass exactly {n_local} frames from this process")
        launches = [{} for _ in range(n_local)]
        cfg = self.cfg
        caller = current()
        with ThreadPoolExecutor(max_workers=n_local, thread_name_prefix="frame-slot") as pool:
            outs = list(pool.map(lambda j: self._run_slot(j, base_img[j], match_img[j], geom_packs[j], cfg, rectified,
                                                          launches[j], caller), range(n_local)))
        results = [o[0] for o in outs]
        rects = [o[1] for o in outs]
        diag = np.array([d for part in all_gather_host([o[2] for o in outs]) for d in part], np.float64)
        cov, offb = diag[:, 0], diag[:, 1]
        shape = tuple(base_img[0].shape)
        info = {"coverage": None, "offband": None, "fallback_frames": [], "launches": launches}
        if _c2f_active(cfg, shape):
            info["coverage"], info["offband"] = cov, offb
        bad = self._select_fallback(cov, offb, shape)
        if bad:
            # Re-run only the tripped frames, each at full range on its
            # owner's device; `bad` is the same on every rank.
            info["fallback_frames"] = bad
            for k in bad:
                if k not in self.local:
                    continue
                j = self.local.index(k)
                bi, mi, gp = outs[j][3]
                res_k, rects_k, _, _ = self._run_slot(j, bi, mi, gp, self.cfg_full, rectified, launches[j], caller)
                self.n_fallback_reruns += 1
                results[j], rects[j] = res_k, rects_k
        mine = []
        for r in results:
            # One read a slot: the plane (float32 values, exact in float64),
            # plane_ok and n_points (exact in float64 below 2**53).
            v = host_read(torch.cat([r.plane.double(), r.plane_ok.double().reshape(1),
                                     r.n_points.double().reshape(1)]), "runner.plane_read").numpy()
            mine.append((v[:4].copy(), bool(v[4]), int(v[5])))
        every = [m for part in all_gather_host(mine) for m in part]
        info["planes"] = np.stack([m[0] for m in every])
        info["plane_ok"] = np.array([m[1] for m in every])
        info["n_points"] = np.array([m[2] for m in every])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # an all-NaN column: no frame had a plane
            mean_plane = np.nanmean(info["planes"], axis=0)
        return results, rects, info, mean_plane

    def _select_fallback(self, cov, offb, shape) -> List[int]:
        """Global slots whose c2f windows missed (a full-range re-run is
        needed).  Separate from run_batch so that tests can drive the
        fallback where c2f itself is inactive."""
        if not _c2f_active(self.cfg, shape):
            return []
        return [k for k in range(len(cov)) if c2f_should_fallback(float(cov[k]), float(offb[k]), self.cfg)]


def initialize_multihost(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, backend: str = "nccl") -> bool:
    """torch.distributed bootstrap (jax.distributed.initialize's place);
    a no-op without a coordinator.  coordinator: "host:port" (a TCP store
    on the rank-0 host) or an init_method URL ("env://" under torchrun,
    which sets the world size and ranks).  backend: "nccl" for CUDA slots,
    one card a rank; "gloo" when asked (several ranks on one card: NCCL
    refuses two ranks on one device).  A failed initialization raises;
    the backend is never switched.  Under NCCL each rank makes its card
    (LOCAL_RANK, else the rank modulo the card count) the current device."""
    if coordinator is None:
        return False
    init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    kwargs = {} if init_method.startswith("env://") else {"world_size": num_processes, "rank": process_id}
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", process_id if process_id is not None else os.environ.get("RANK", 0)))
        torch.cuda.set_device(local % max(torch.cuda.device_count(), 1))
    dist.init_process_group(backend, init_method=init_method, **kwargs)
    return True
