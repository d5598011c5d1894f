#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (wass_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero:

1. The card: `nvidia-smi` name and power limit, torch's device name.
2. Build the CUDA kernels from wass_tpu_torch/csrc with nvcc (sm_90a), one
   nvcc per source, all started together; ptxas's register and spill
   report lands in wass_tpu_torch/_build/ptxas.log.
3. Each kernel against its plain PyTorch version on the card, bit-equal,
   with times from CUDA events at the slice's shapes: the rectified
   2048x1536 pair, D = 640 and 8 paths for K1/K3/K5/K7; Dw = 128 over the
   window starts of the pair's coarse pass for K2/K4/K6; the coarse pass's
   K1 and K3 (384x512, D = 160) timed too; K1 and K2 also over a 9x9
   census (3 words), at both shapes.  K7 also on a 2048x1536 serpentine
   mask (bands every 4 rows joined at alternating ends) that no 24 rounds
   make converge, where all 24 rounds must change labels; the rounds that
   did work are printed for both masks.  Then at a
   ragged shape: 1001x777, D = 52 for K1/K3/K5/K7, and 1000x776, Dw = 52
   with random window starts (flat, rising, falling, jumps of >= Dw) for
   K2/K4/K6.  The five H2 kernels (the JAX package's _USE_H2 pieces) and
   the single non-H2 walks of the H2 compositions (sgm_walk) the same way,
   on the same volumes and on the coarse pass's (384x512, D = 160, with
   K1 and K3 there too), with their times; and the four public SGM entry
   points with sgm_kernels._USE_H2 set, bit-equal to their default path
   (5 and 8 paths), timed both ways at the slice's shapes.
4. The main path: a synthetic 2048x1536 wave-field pair (rendered once and
   cached in wass_tpu_torch/_build/) written as 3 frame workdirs, then
   `python -m wass_tpu_torch.cli.main stereo <outdir>`'s entry point with
   the stereo defaults (MAX_DISPARITY = 640, the coarse-to-fine window of
   128), through the production loop (PNG prefetch threads, 3 frames
   dispatched ahead, 2 writer threads, the c2f fallback resolved by the
   writers).  Every frame must take the windowed branch, give a plane.txt and
   a mesh_cam.xyzC that read back through the workdir contract
   (wass_tpu_torch.testing.read_frame), a trimmed-mean elevation error
   below 0.02 baseline units, and must have launched K1, K2, K3, K4 and
   K7.  Every frame (here and in 4b, 4c) prints the sha256 of its
   mesh_cam.xyzC and plane.txt, so that runs of two commits on one card
   compare byte for byte.
4b. The other branches, one frame each through SequencePipeline with a
   config override: a forced full-range fallback (c2f_min_coverage 1.01),
   byte-identical to a c2f_window = 0 frame (K1 + K3 + K7), whose launch
   line counts its writer's full-range re-run (K7 twice); the
   left-right check (lr_max_diff 1: K1 + K5 + K7); 2 paths over the
   windows (K2 + K6, the coarse pass on K1 + K5); 5 paths over the
   windows (K2 + K4 after an 8-path coarse pass) and at full range (K1 +
   K3), the first 5-path frames, their elevation error printed, not gated.
4c. H2 frames through SequencePipeline with sgm_kernels._USE_H2 set: c2f
   with 8 and with 5 paths, full range with 5 paths, the left-right check.
   Each frame's mesh_cam.xyzC and plane.txt must be byte-identical to the
   same configuration's frame with H2 off (phase 4's first frame, the 4b
   frames), no frame may launch the default path's K3-K6, and the runs
   together must launch every H2 kernel and sgm_walk.
P. Prepare on the card: the scene's surface traced through a known lens
   (PREP_DIST, |k1| <= 0.05; the render cached in wass_tpu_torch/_build/
   beside the scene) as PREP_FRAMES raw PNG pairs with calib/ (intrinsics,
   distortion, ext_R, ext_T), then `prepare`, `genconfig --stage stereo`
   and `stereo` through the CLI's entry point; every frame must take the
   windowed branch and meet the 0.02 gate.  Prints prepare's frames/s, the
   device ms of undistort_image and clahe per image (CUDA events), the host
   ms of the PNG encode and decode (filter-0 and Paeth rows, and Paeth
   decodes one after another against the 4-thread prefetcher), then one
   frame prepared with CLAHE (tiles of CLAHE_TILE_PX, from
   prepare_config.txt) through SequencePipeline.prepare and reconstructed,
   its elevation error printed, not gated.
M. Match and autocalibrate on the card (phase M): MATCH_FRAMES workdirs of
   the scene's pair without ext_R/ext_T.  First the iidyn kernel (one
   thread-block cluster) against its plain version on frame 0's
   first-round payoff (C = 4000 features x 3 candidates = 12000) and on
   the cluster's edges, planted cliques: C = 2000; 5 live of 3000 (CTAs
   that hold none); one live; C not a multiple of GROUPS x THREADS; the
   largest C whose payoff takes 30% of the card's free memory: bit-equal
   x, update count and Nash error after 64 updates and at convergence (the
   plain version adds in the kernel's order); the kernel's time per round
   beside the plain version's, with the cluster's shape and the card.
   Then `match` and `autocalibrate` through the CLI's entry point with the
   matcher defaults (AUTO budget 4000, grid cell 8, 20000 iidyn
   iterations, 20 rounds, AUTO LK window and smoothing) but
   FEATURE_HESSIAN_THRESHOLD = MATCH_HESSIAN, and `stereo` on frame 0
   with the match stage's extrinsics and again with the pooled ones.
   Gates: >= 400 pose-inlier matches, <= 0.5 px epipolar error and the
   pose within dR 5e-3 and dT 2e-2 of the rig a frame, the pooled pose
   within the same (verify_matcher.m:6-8), byte-identical matches*.txt
   across the frames (the same pair), both stereo frames windowed with a
   plane and a mesh, iidyn launched.  The two frames' elevation errors are
   printed, not gated at 0.02: the pose that one pair gives is a few 1e-4
   from the rig in R (printed), and the mesh error follows it.  That is
   the method's spread on one pair, not the port's: on this pair the JAX
   package's own pooled pose moves between 2e-5 and 5.5e-4 in R when
   N(0, 0.01) grey levels are added to the images, and the port's stage
   on the JAX package's features gives the JAX package's pose to 5e-7
   for four draws of five (tests/torch_match_witness.py, on the CPU).
   Then, measurement only, the device ms of each match and autocalibrate
   stage on frame 0's pair and frame 0 matched with the default threshold
   (printed, not gated).  Then POOL_SEEDS' four distinct scenes of the rig
   (the three new ones rendered on the card), one workdir each, through
   `match` and `autocalibrate`: the pooled pose gated as above, the
   elevation error of the first scene's frame made with it printed, not
   gated.  Last, a line of iidyn's times: frame 0's first round, the
   match frame's 20 rounds and its wall time, with the card.
5. Where the c2f frame's time goes: the sequence loop's frames/s over
   LOOP_FRAMES frames through SequencePipeline at each (dispatch_depth,
   writer_threads) of LOOP_SETTINGS (3 passes each, the first one with the
   warm-up), with the PNG decode ms on the prefetch threads, the main
   thread's dispatch ms per frame and the peak device memory; the host
   syncs of one dispatched frame (torch.cuda.set_sync_debug_mode); the
   frame's device stages one after another (CUDA events, a synchronize
   between stages, 3 repeats) and K7's rounds on the frame's own z-gap
   mask.  Measurement only: nothing here is counted as a launch of the
   main path.
G. The grid stage on phase 5's ten frames (2048x1536, c2f, ~2.7M points
   a frame): `wass-tpu-torch-gridsurface --action setup` (GRID_AREA m
   about frame 0's median point, N = 256) and `--action grid` (DCT, 500
   iterations, nreps 10) through the console's entry point, with the
   seconds a frame, each stage's device ms (CUDA events, a synchronize
   around each: binning, the median stack, the DCT fit) and host ms (the
   mesh load, the slab write), the peak device memory and the cube's
   bytes; then the grid again, untimed.  Gates: the two runs' Z
   byte-identical; Z read back (the port's NetCDFReader) equal to the
   pushed grids, with the shapes, count, time and workdir written;
   cam0images[0] decoding to the undistorted frame; frame 0 on the card
   and on the CPU with the same draws: the bins equal, the median stack
   bit-equal, the DCT fit within tests/test_torch_grid.py's tolerance.
   Printed, not gated: the RMS of frame 0's gridded Z against the scene's
   wave field.  Then one frame each of GRID_MODES (N = 512, IDW, the
   outlier votes, -mf 3, LinearND at 10%, the zero-mean rewrite), each
   giving more than GRID_MIN_FINITE finite cells.
S. The post stage (phase S) on a cube of phase G's grid and meta (N = 256,
   its config.mat, P0plane and Cam0toGrid): POST_FRAMES frames at POST_FPS
   (200 s; users film 10-30 min at 10-20 Hz, the cut is the duration), Z
   the scene's wave field (mm) at the grid nodes' world x, y, written by
   the port's NetCDFWriter (786 MB of Z, over the 512 MB default budget,
   so every streaming path runs).  First the visibility march against its
   plain version, bit-equal: an 8-frame slab as visibilitymap lays the
   cube out, with x along the columns, and with a camera 0.5 m above the
   plane (grazing rays that march); frame 0 with a NaN hole (maxz NaN,
   then its nanmax); a whole 341-frame slab of the command, timed.  Then
   `wass-tpu-torch-post` through its entry point: info, spectrum (nperseg
   512, rangespan 5), spectrum3d (10 segments), filter (lowpass 1 Hz),
   spatial_lowpass, zeromean, clip, setfps, visibilitymap over every frame
   toward cam 0, renamevar; and on phase G's ten-frame cube (its PNG
   cam0images) radiance, bgimage and radiance_threshold with and without
   --use-vats.  Each command prints its seconds, the device ms of its
   device stages (CUDA events around the FFTs, the bilinear sample, the
   visibility batch and the march), the host ms of its dataset reads and
   writes, the peak device memory and the bytes the cube grew;
   visibilitymap also its launches, ms a slab and the share occluded.
   Gates: every output read back with the JAX command's names, shapes and
   dtypes, Z_filtered unchanged by visibilitymap (sha256); spectrum's Hm0
   within 10% of the field's 1.0 m; the card's spectrum within 1e-5 of
   max S of the port's CPU run on the same patch; after zeromean |time
   mean| < 1e-3 mm at every finite cell.
6. A JSON line of per-kernel results (times, launches, and the bound: the
   larger of the bytes the function must move, each input read once and
   each output written once, at 3.35 TB/s, and its integer operations at
   67 T/s, and for K1/K2 their popcounts at 16 a clock per SM at the
   maximum SM clock nvidia-smi reports; iidyn's is its updates' rows of A
   at the live columns, 4 n_live bytes each; the march's 17 bytes a ray,
   Z, d and the flag; no single PyTorch call
   computes any of these
   functions, so library_ms is null), then the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}},
   after a line with the whole script's seconds.

Exits non-zero without a result when there is no CUDA device or when the
port's package is not next to this script.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
W, H, D = 2048, 1536, 640
DW = 128  # the c2f window of the stereo defaults
RAGGED = (777, 1001, 52)  # (H, W, D); the windowed kernels take H and W down to 776 x 1000
RAGGED_NUM_DISP = 200  # window starts of the ragged case lie in [1, 1 + 200 - Dw]
N_FRAMES = 3
SCENE_SEED = 7
ELEVATION_GATE = 0.02  # verify_meshes trimmed-mean gate, baseline units
LABEL_ROUNDS = 24  # K7 rounds of the main path (2 x the max_iters of 12)
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_INT_OPS_PER_S = 67e12  # H100 SXM, outside the tensor cores
POPC_PER_CLOCK_PER_SM = 16  # __popc results a clock per SM on sm_90, a quarter of the XOR/IADD rate
CENSUS_9X9 = (9, 9)  # a 3-word census (80 bits), checked beside the default 7x9 (2 words)
SGM_OPS = 8  # integer operations per cost element and path (3 min, 3 add/sub, 2 compare)
LOOP_FRAMES = 10  # frames of the sequence-loop timing (phase 5)
LOOP_SETTINGS = ((1, 1), (3, 2))  # (dispatch_depth, writer_threads) timed in phase 5
PREP_FRAMES = 3  # raw frames of phase P
# The known lens of phase P's raw frames, (k1, k2, p1, p2, k3) per camera:
# barrel distortion on both, as wide-angle lenses have, so the undistorted
# images keep every pixel (a pincushion lens leaves a black border, whose
# points fail the elevation gate).
PREP_DIST = ([-0.04, 0.01, 2e-4, -1e-4, 0.0], [-0.03, 0.005, 0.0, 0.0, 0.0])
CLAHE_TILE_PX = 150  # CAM{0,1}_CLAHE_TILEGRIDSIZE of phase P's CLAHE frame
MATCH_FRAMES = 3  # frame workdirs of phase M (the same pair)
# Phase M's pooled scenes: make_scene seeds of the same rig (SCENE_SEED's
# and three more), one workdir each, rendered on the card (render_pair).
POOL_SEEDS = (SCENE_SEED, 11, 12, 13)
# FEATURE_HESSIAN_THRESHOLD of phase M's matcher_config.txt, the value the
# JAX package's own tests use for these synthetic scenes
# (tests/test_match.py:110): with the default 1e-4 the scene's smooth
# texture leaves ~400 features an image and fewer matches than the 400
# gate, in the JAX package as in the port (190 and 177 on the CPU,
# tests/torch_match_witness.py; phase M prints the card's).
MATCH_HESSIAN = 3e-5
IIDYN_CAP = 64  # updates of the capped kernel-vs-plain iidyn runs
IIDYN_ITERS = 20000  # MatchConfig.iidyn_iters
IIDYN_PLAIN_TIMED = 200  # updates of the plain iidyn timing
# The reference's matcher gates (verify_matcher.m:6-8): matches a frame,
# average epipolar px, pooled max |dR| and max |dT| against the rig.
MATCH_GATES = (400, 0.5, 5e-3, 2e-2)

KERNELS = {
    "census_cost": ("wass_tpu_torch/csrc/census_cost.cu", "wass_tpu/stereo/sgm_pallas.py:710"),
    "census_cost_windowed": ("wass_tpu_torch/csrc/census_cost.cu", "wass_tpu/stereo/sgm_pallas.py:808"),
    "sgm_wta_fused": ("wass_tpu_torch/csrc/sgm.cu", "wass_tpu/stereo/sgm_pallas.py:633"),
    "sgm_wta_fused_windowed": ("wass_tpu_torch/csrc/sgm.cu", "wass_tpu/stereo/sgm_pallas.py:1228"),
    "sgm_aggregate": ("wass_tpu_torch/csrc/sgm.cu", "wass_tpu/stereo/sgm_pallas.py:313"),
    "sgm_aggregate_windowed": ("wass_tpu_torch/csrc/sgm.cu", "wass_tpu/stereo/sgm_pallas.py:1281"),
    "label_propagate": ("wass_tpu_torch/csrc/components.cu", "wass_tpu/ops/components_pallas.py:103"),
    "sgm_pair_img": ("wass_tpu_torch/csrc/sgm.cu", "wass_tpu/stereo/sgm_pallas.py:208"),
    "sgm_tri_dir_partial_h2": ("wass_tpu_torch/csrc/sgm.cu", "wass_tpu/stereo/sgm_pallas.py:520"),
    "sgm_tri_dir_wta_h2": ("wass_tpu_torch/csrc/sgm.cu", "wass_tpu/stereo/sgm_pallas.py:546"),
    "sgm_tri_dir_partial_windowed_h2": ("wass_tpu_torch/csrc/sgm.cu", "wass_tpu/stereo/sgm_pallas.py:1099"),
    "sgm_tri_dir_wta_windowed_h2": ("wass_tpu_torch/csrc/sgm.cu", "wass_tpu/stereo/sgm_pallas.py:1130"),
    # The single non-H2 walks of the H2 compositions (_run_tri_dir_wta, and
    # _run_tri_dir, _run_tri_dir_windowed, _run_tri_dir_wta_windowed).
    "sgm_walk": ("wass_tpu_torch/csrc/sgm.cu", "wass_tpu/stereo/sgm_pallas.py:602"),
    # Not a Pallas kernel: the match rounds' lax.while_loop, one kernel a round.
    "iidyn": ("wass_tpu_torch/csrc/iidyn.cu", "wass_tpu/match/iidyn.py:25"),
    # Not a Pallas kernel: the visibility ray march's lax.while_loop, one kernel a slab.
    "visibility_march": ("wass_tpu_torch/csrc/visibility.cu", "wass_tpu/post/geometry.py:94"),
}
# The default path's SGM keys, which no H2 frame may launch.
DEFAULT_SGM = ("sgm_wta_fused", "sgm_wta_fused_windowed", "sgm_aggregate", "sgm_aggregate_windowed")
# Kernels each main-path run must launch (phase 4 per frame, phase 4b per run).
WINDOWED_PATH = ("census_cost", "census_cost_windowed", "sgm_wta_fused", "sgm_wta_fused_windowed", "label_propagate")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 1) -> float:
    """Mean device time of fn() over reps runs (CUDA events, after a warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name: str, kernel_out, plain_out) -> float:
    """Max |kernel - plain|; raises unless the two are bit-equal."""
    import torch

    torch.cuda.synchronize()
    if kernel_out.shape != plain_out.shape or kernel_out.dtype != plain_out.dtype:
        raise AssertionError(f"{name}: {kernel_out.shape}/{kernel_out.dtype} vs {plain_out.shape}/{plain_out.dtype}")
    if torch.equal(kernel_out, plain_out):
        return 0.0
    ne = kernel_out != plain_out  # float64 copies of whole volumes would not fit beside them
    err = (kernel_out[ne].double() - plain_out[ne].double()).abs().max().item()
    raise AssertionError(f"{name}: kernel differs from the plain version (max abs err {err})")


def _record(results: dict, name: str, kernel_out, plain_out, what: str) -> None:
    err = compare(f"{name} {what}", kernel_out, plain_out)
    results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
    log(f"kernel {name} {what}: bit-equal")


_popc_per_s = None


def popc_per_s() -> float:
    """The card's popcount rate: SMs x 16 a clock x the maximum SM clock
    that nvidia-smi reports (the clock is printed once)."""
    global _popc_per_s
    if _popc_per_s is None:
        import torch

        mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                                   capture_output=True, text=True, check=True).stdout.split()[0])
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        _popc_per_s = sms * POPC_PER_CLOCK_PER_SM * mhz * 1e6
        log(f"popcount rate: {sms} SMs x {POPC_PER_CLOCK_PER_SM} a clock x {mhz:.0f} MHz = {_popc_per_s:.4g}/s")
    return _popc_per_s


def bound(nbytes: float, ops: float, popc: float = 0.0) -> tuple:
    """(ms, "bytes" or "operations"): the least time the card could take
    for one call, the bytes the function must move (each input read once,
    each output written once) over the memory rate or its integer
    operations, at the ALU rate and its popcounts at the popcount rate,
    whichever is larger."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = max(ops / PEAK_INT_OPS_PER_S, popc / popc_per_s() if popc else 0.0)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def set_bound(results: dict, name: str, nbytes: float, ops: float) -> None:
    results[name]["bound_ms"], results[name]["bound_by"] = bound(nbytes, ops)


def census_bound(cb, d: int, extra_bytes: int = 0) -> tuple:
    """K1/K2's bound for an (H, W, d) volume from census words cb: both
    images' words (and extra_bytes) in, the volume out; an XOR and an add,
    and a popcount, per word and output."""
    n = cb.shape[0] * cb.shape[1] * d
    return bound(2 * cb.numel() * 4 + extra_bytes + n, 2 * n * cb.shape[2], n * cb.shape[2])


def label_inputs(valid, disp=None):
    """K7's inputs for a mask: linear-index labels (INT32_MAX off the mask)
    and 4-neighbour connectivity, gated where the disparity steps by one
    pixel or more when disp is given (a z-gap-like gate)."""
    import torch

    idx = torch.arange(valid.numel(), dtype=torch.int32, device=valid.device).reshape(valid.shape)
    init = torch.where(valid, idx, torch.iinfo(torch.int32).max)
    join_v, join_h = valid[1:] & valid[:-1], valid[:, 1:] & valid[:, :-1]
    if disp is not None:
        join_v = join_v & ((disp[:-1] - disp[1:]).abs() < 1)
        join_h = join_h & ((disp[:, :-1] - disp[:, 1:]).abs() < 1)
    conn_v = torch.zeros_like(valid, dtype=torch.uint8)
    conn_h = torch.zeros_like(valid, dtype=torch.uint8)
    conn_v[1:] = join_v.to(torch.uint8)
    conn_h[:, 1:] = join_h.to(torch.uint8)
    return init, conn_v, conn_h


def serpentine_mask(shape, every: int, dev):
    """Bands every `every` rows joined at alternating ends: one component
    whose smallest label crosses about one band a K7 round."""
    import torch

    H, W = shape
    mask = torch.zeros(shape, dtype=torch.bool, device=dev)
    mask[::every] = True
    for k, r in enumerate(range(0, H, every)):
        mask[r:r + every, W - 1 if k % 2 == 0 else 0] = True
    return mask


def ragged_windows(n_tiles: int, dw: int, gen) -> "torch.Tensor":
    """Random window starts in [1, 1 + RAGGED_NUM_DISP - dw] with a flat
    step, a rise, a fall and jumps of >= dw both ways."""
    import torch

    hi = 1 + RAGGED_NUM_DISP - dw
    ws = torch.randint(1, hi + 1, (n_tiles,), generator=gen, dtype=torch.int32)
    ws[1] = ws[0]
    ws[2], ws[3], ws[4], ws[5] = 1, hi, 1, 5  # +-(hi - 1) >= dw, then a small rise
    return ws


@contextlib.contextmanager
def h2_on():
    """sgm_kernels._USE_H2 set for the block, restored after it."""
    from wass_tpu_torch.stereo import sgm_kernels as sk

    sk._USE_H2 = True
    try:
        yield
    finally:
        sk._USE_H2 = False


def check_h2_pieces(results: dict, what: str, cost, ws=None) -> None:
    """Phase 3, H2: the pair, the folding walks and the single non-H2 walks
    of the H2 compositions (sgm_walk) against their plain versions on one
    full-range (ws None) or windowed cost volume."""
    import torch

    from wass_tpu_torch.stereo import sgm as plain_sgm
    from wass_tpu_torch.stereo import sgm_kernels as sk

    hf, hb = sk.sgm_pair_img(cost, 8, 96)
    phf, phb = plain_sgm.run_pair_img_plain(cost, 8, 96)
    _record(results, "sgm_pair_img", hf, phf, f"{what} hf")
    _record(results, "sgm_pair_img", hb, phb, f"{what} hb")
    del phf, phb
    if ws is None:
        partial = sk.sgm_tri_dir_partial_h2(cost, hf, hb, 8, 96, False)
        _record(results, "sgm_tri_dir_partial_h2", partial,
                plain_sgm.run_tri_dir_partial_h2_plain(cost, hf, hb, 8, 96, False), what)
        _record(results, "sgm_tri_dir_wta_h2", sk.sgm_tri_dir_wta_h2(cost, hf, hb, 8, 96, False, 1, 1),
                plain_sgm.run_tri_dir_wta_h2_plain(cost, hf, hb, 8, 96, False, 1, 1), what)
        del hf, hb
        final = sk.sgm_tri_dir_wta(cost, partial.clone(), 8, 96, True, 1, 1)
        plain_final = plain_sgm.run_tri_dir_wta_plain(cost, partial, 8, 96, True, 1, 1)
    else:
        partial = sk.sgm_tri_dir_partial_windowed_h2(cost, hf, hb, ws, 8, 96, False)
        _record(results, "sgm_tri_dir_partial_windowed_h2", partial,
                plain_sgm.run_tri_dir_partial_windowed_h2_plain(cost, hf, hb, ws, 8, 96, False), what)
        _record(results, "sgm_tri_dir_wta_windowed_h2", sk.sgm_tri_dir_wta_windowed_h2(cost, hf, hb, ws, 8, 96, False, 1),
                plain_sgm.run_tri_dir_wta_windowed_h2_plain(cost, hf, hb, ws, 8, 96, False, 1), what)
        del hf, hb
        final = sk.sgm_tri_dir_wta_windowed(cost, partial.clone(), ws, 8, 96, True, 1)
        plain_final = plain_sgm.run_tri_dir_wta_windowed_plain(cost, partial, ws, 8, 96, True, 1)
    # sgm_walk: the 8-path final walk over the H2 partial (the plain one
    # added its walk into `partial`), then an aggregate's walk into that sum.
    _record(results, "sgm_walk", final, plain_final, f"{what} final walk")
    _record(results, "sgm_walk", sk.sgm_walk_add(cost, partial.clone(), "fwd", 8, 96, ws),
            plain_sgm.walk_add(cost, partial, "fwd", 8, 96, ws), f"{what} walk_add")
    del partial, final, plain_final
    torch.cuda.empty_cache()


def check_h2(results: dict, tag: str, cost, wcost, ws, shape: str, wshape: str) -> None:
    """Phase 3, H2: each H2 kernel against its plain version on the
    volumes of check_kernels, then the public entry points with H2 against
    their default path; at the slice's shapes, the times of both."""
    import torch

    from wass_tpu_torch.stereo import sgm as plain_sgm
    from wass_tpu_torch.stereo import sgm_kernels as sk

    check_h2_pieces(results, f"{tag} {shape}", cost)
    check_h2_pieces(results, f"{tag} {wshape}", wcost, ws)

    compositions = {
        "sgm_wta_fused 5": lambda: sk.sgm_wta_fused(cost, 8, 96, 5, 1, 1),
        "sgm_wta_fused 8": lambda: sk.sgm_wta_fused(cost, 8, 96, 8, 1, 1),
        "sgm_aggregate 8": lambda: sk.sgm_aggregate(cost, 8, 96, 8),
        "sgm_wta_fused_windowed 5": lambda: sk.sgm_wta_fused_windowed(wcost, ws, 8, 96, 5, 1),
        "sgm_wta_fused_windowed 8": lambda: sk.sgm_wta_fused_windowed(wcost, ws, 8, 96, 8, 1),
        "sgm_aggregate_windowed 8": lambda: sk.sgm_aggregate_windowed(wcost, ws, 8, 96, 8),
    }
    for name, fn in compositions.items():
        default = fn()
        with h2_on():
            compare(f"{name} with H2 {tag}", fn(), default)
        log(f"entry point {name} {tag} {wshape if 'windowed' in name else shape}: H2 bit-equal to the default path")
        del default
    if tag != "slice":
        return

    hf, hb = sk.sgm_pair_img(cost, 8, 96)
    whf, whb = sk.sgm_pair_img(wcost, 8, 96)
    acc = torch.zeros(cost.shape, dtype=torch.int16, device=cost.device)  # sums grow by < 500 a call
    timed = {
        "sgm_pair_img": (lambda: sk.sgm_pair_img(cost, 8, 96), lambda: plain_sgm.run_pair_img_plain(cost, 8, 96)),
        "sgm_tri_dir_partial_h2": (lambda: sk.sgm_tri_dir_partial_h2(cost, hf, hb, 8, 96, False),
                                   lambda: plain_sgm.run_tri_dir_partial_h2_plain(cost, hf, hb, 8, 96, False)),
        "sgm_tri_dir_wta_h2": (lambda: sk.sgm_tri_dir_wta_h2(cost, hf, hb, 8, 96, False, 1, 1),
                               lambda: plain_sgm.run_tri_dir_wta_h2_plain(cost, hf, hb, 8, 96, False, 1, 1)),
        "sgm_tri_dir_partial_windowed_h2": (
            lambda: sk.sgm_tri_dir_partial_windowed_h2(wcost, whf, whb, ws, 8, 96, False),
            lambda: plain_sgm.run_tri_dir_partial_windowed_h2_plain(wcost, whf, whb, ws, 8, 96, False)),
        "sgm_tri_dir_wta_windowed_h2": (
            lambda: sk.sgm_tri_dir_wta_windowed_h2(wcost, whf, whb, ws, 8, 96, False, 1),
            lambda: plain_sgm.run_tri_dir_wta_windowed_h2_plain(wcost, whf, whb, ws, 8, 96, False, 1)),
        # The 8-path final walk (backward, with the WTA), adding into acc.
        "sgm_walk": (lambda: sk.sgm_tri_dir_wta(cost, acc, 8, 96, True, 1, 1),
                     lambda: plain_sgm.run_tri_dir_wta_plain(cost, acc, 8, 96, True, 1, 1)),
    }
    n, nw, hw, nws = cost.numel(), wcost.numel(), cost.shape[0] * cost.shape[1], 4 * ws.numel()
    set_bound(results, "sgm_pair_img", 3 * n, SGM_OPS * 2 * n)
    set_bound(results, "sgm_tri_dir_partial_h2", 5 * n, SGM_OPS * 3 * n)
    set_bound(results, "sgm_tri_dir_wta_h2", 3 * n + 4 * hw, SGM_OPS * 3 * n)
    set_bound(results, "sgm_tri_dir_partial_windowed_h2", 5 * nw + nws, SGM_OPS * 3 * nw)
    set_bound(results, "sgm_tri_dir_wta_windowed_h2", 3 * nw + nws + 4 * hw, SGM_OPS * 3 * nw)
    set_bound(results, "sgm_walk", 5 * n + 4 * hw, SGM_OPS * 3 * n)  # cost and sum in, sum and disparity out
    for name, (kernel, plain) in timed.items():
        results[name]["ms"] = cuda_ms(kernel, 3)
        results[name]["plain_ms"] = cuda_ms(plain)
        log(f"time {name} {shape if 'windowed' not in name else wshape}: "
            f"kernel {results[name]['ms']:.3f} ms, plain {results[name]['plain_ms']:.3f} ms, "
            f"bound {results[name]['bound_ms']:.3f} ms")
    del hf, hb, whf, whb, acc
    torch.cuda.empty_cache()
    # The entry points both ways, in the order default, H2, H2, default.
    for name, fn in compositions.items():
        t = [cuda_ms(fn, 3)]
        with h2_on():
            t += [cuda_ms(fn, 3), cuda_ms(fn, 3)]
        t.append(cuda_ms(fn, 3))
        log(f"time entry point {name} {wshape if 'windowed' in name else shape}: default {t[0]:.3f} {t[3]:.3f} ms, "
            f"H2 {t[1]:.3f} {t[2]:.3f} ms")


def check_kernels(img_pair, dev) -> dict:
    """Phase 3: kernel vs plain at the slice's and a ragged shape."""
    import torch

    from wass_tpu_torch.ops import components_kernels as ck
    from wass_tpu_torch.stereo import c2f
    from wass_tpu_torch.stereo import sgm as plain_sgm
    from wass_tpu_torch.stereo import sgm_kernels as sk
    from wass_tpu_torch.stereo.cost import census_cost_volume, census_cost_volume_windowed, census_transform

    results = {name: {"max_abs_err": 0.0} for name in KERNELS}
    gen = torch.Generator().manual_seed(0)
    ragged_h, ragged_w, ragged_d = RAGGED
    cases = [
        ("slice", torch.as_tensor(img_pair[0]), torch.as_tensor(img_pair[1]), D, DW),
        ("ragged", torch.rand((ragged_h, ragged_w), generator=gen) * 255,
         torch.rand((ragged_h, ragged_w), generator=gen) * 255, ragged_d, ragged_d),
    ]
    for tag, a, b, nd, dw in cases:
        base, match = a.to(dev, torch.float32), b.to(dev, torch.float32)
        cb, cm = census_transform(base, (7, 9), 0.8), census_transform(match, (7, 9), 0.8)
        shape = f"{tuple(base.shape)} D={nd}"

        cost = sk.census_cost_volume(cb, cm, nd, 1)
        _record(results, "census_cost", cost, census_cost_volume(cb, cm, nd, 1), f"{tag} {shape}")

        for dirs in (5, 8):  # the 8-path disparity feeds the label check
            disp = sk.sgm_wta_fused(cost, 8, 96, dirs, 1, 1)
            _record(results, "sgm_wta_fused", disp, plain_sgm.sgm_wta_fused_plain(cost, 8, 96, dirs, 1, 1),
                    f"{tag} {shape} directions={dirs}")

        agg = sk.sgm_aggregate(cost, 8, 96, 8)
        _record(results, "sgm_aggregate", agg, plain_sgm.sgm_aggregate(cost, 8, 96, 8), f"{tag} {shape} directions=8")
        del agg

        # Labels of the valid-disparity mask, 4-neighbours joined where the
        # disparity steps by less than one pixel (a z-gap-like gate).
        valid = disp > 0
        init, conn_v, conn_h = label_inputs(valid, disp)
        k_lab = ck.propagate_labels(init, conn_v, conn_h, LABEL_ROUNDS)
        _record(results, "label_propagate", k_lab, ck.propagate_labels_plain(init, conn_v, conn_h, LABEL_ROUNDS),
                f"{tag} {tuple(valid.shape)} ({int(torch.unique(k_lab[valid]).numel())} components)")
        label_rounds = ck.rounds_changed()
        log(f"label_propagate {tag}: {label_rounds} of {LABEL_ROUNDS} rounds changed labels")
        if tag == "slice":  # a mask that cannot converge: every round must run and change labels
            serp = serpentine_mask(valid.shape, 4, dev)
            s_init, s_conn_v, s_conn_h = label_inputs(serp)
            _record(results, "label_propagate", ck.propagate_labels(s_init, s_conn_v, s_conn_h, LABEL_ROUNDS),
                    ck.propagate_labels_plain(s_init, s_conn_v, s_conn_h, LABEL_ROUNDS),
                    f"serpentine {tuple(serp.shape)} (bands every 4 rows)")
            serp_rounds = ck.rounds_changed()
            log(f"label_propagate serpentine: {serp_rounds} of {LABEL_ROUNDS} rounds changed labels")
            if serp_rounds != LABEL_ROUNDS:
                raise AssertionError(f"serpentine mask: {serp_rounds} rounds changed labels, not {LABEL_ROUNDS}")
            log(f"time label_propagate serpentine {tuple(serp.shape)}: kernel "
                f"{cuda_ms(lambda: ck.propagate_labels(s_init, s_conn_v, s_conn_h, LABEL_ROUNDS), 3):.3f} ms "
                f"({LABEL_ROUNDS} rounds)")
            del serp, s_init, s_conn_v, s_conn_h

        # The windowed kernels: the slice's windows come from the pair's
        # coarse pass, the ragged ones are random.
        if tag == "slice":
            disp_c = c2f.coarse_disparity(base, match, nd, 1, 8, 96, 8, (7, 9), 1, 4)
            ws, cov, offband = c2f.compute_row_windows(disp_c, 4, nd, 1, dw)
            wcb, wcm = cb, cm
            log(f"slice windows: coverage {float(cov):.4f} offband {float(offband):.5f}, "
                f"starts {int(ws.min())}..{int(ws.max())}")
            # The coarse pass's volume (384x512, D = 160, lane width 8): K1,
            # K3 and the H2 pieces its 8-path pass launches with H2 on.
            ccb, ccm = (census_transform(c2f.downsample_pool(x, 4), (7, 9), 0.0) for x in (base, match))
            cnd = c2f.coarse_num_disp(nd, 4)
            ccost = sk.census_cost_volume(ccb, ccm, cnd, 1)
            cshape = f"coarse {tuple(ccb.shape[:2])} D={cnd}"
            _record(results, "census_cost", ccost, census_cost_volume(ccb, ccm, cnd, 1), cshape)
            ck1_bound = census_bound(ccb, cnd)
            log(f"time census_cost {cshape}: kernel {cuda_ms(lambda: sk.census_cost_volume(ccb, ccm, cnd, 1), 20):.4f} ms, "
                f"plain {cuda_ms(lambda: census_cost_volume(ccb, ccm, cnd, 1)):.3f} ms, "
                f"bound {ck1_bound[0]:.4f} ms ({ck1_bound[1]})")
            _record(results, "sgm_wta_fused", sk.sgm_wta_fused(ccost, 8, 96, 8, 1, 1),
                    plain_sgm.sgm_wta_fused_plain(ccost, 8, 96, 8, 1, 1), f"{cshape} directions=8")
            coarse_bound = bound(ccost.numel() + 4 * ccb.shape[0] * ccb.shape[1], SGM_OPS * 8 * ccost.numel())
            log(f"time sgm_wta_fused {cshape}: kernel {cuda_ms(lambda: sk.sgm_wta_fused(ccost, 8, 96, 8, 1, 1), 5):.3f} ms, "
                f"plain {cuda_ms(lambda: plain_sgm.sgm_wta_fused_plain(ccost, 8, 96, 8, 1, 1)):.3f} ms, "
                f"bound {coarse_bound[0]:.3f} ms ({coarse_bound[1]})")
            check_h2_pieces(results, cshape, ccost)
            del ccost
        else:
            h8, w8 = ragged_h // 8 * 8, ragged_w // 8 * 8
            wcb, wcm = cb[:h8, :w8].contiguous(), cm[:h8, :w8].contiguous()
            ws = ragged_windows(h8 // 8, dw, gen).to(dev)
        wshape = f"{tuple(wcb.shape[:2])} Dw={dw}"
        wcost = sk.census_cost_volume_windowed(wcb, wcm, ws, dw)
        _record(results, "census_cost_windowed", wcost, census_cost_volume_windowed(wcb, wcm, ws, dw),
                f"{tag} {wshape}")
        for dirs in (5, 8):
            _record(results, "sgm_wta_fused_windowed", sk.sgm_wta_fused_windowed(wcost, ws, 8, 96, dirs, 1),
                    plain_sgm.sgm_wta_fused_windowed_plain(wcost, ws, 8, 96, dirs, 1), f"{tag} {wshape} directions={dirs}")
        _record(results, "sgm_aggregate_windowed", sk.sgm_aggregate_windowed(wcost, ws, 8, 96, 8),
                plain_sgm.sgm_aggregate_windowed(wcost, ws, 8, 96, 8), f"{tag} {wshape} directions=8")

        # A 3-word census (9x9) through K1 and K2, at the same shapes and windows.
        cb9, cm9 = (census_transform(x, CENSUS_9X9, 0.8) for x in (base, match))
        what = f"census 9x9 (nw={cb9.shape[2]})"
        _record(results, "census_cost", sk.census_cost_volume(cb9, cm9, nd, 1), census_cost_volume(cb9, cm9, nd, 1),
                f"{tag} {shape} {what}")
        wcb9, wcm9 = (x[:wcb.shape[0], :wcb.shape[1]].contiguous() for x in (cb9, cm9))
        _record(results, "census_cost_windowed", sk.census_cost_volume_windowed(wcb9, wcm9, ws, dw),
                census_cost_volume_windowed(wcb9, wcm9, ws, dw), f"{tag} {wshape} {what}")
        if tag == "slice":
            for name, fn, (b_ms, b_by) in (
                    ("census_cost", lambda: sk.census_cost_volume(cb9, cm9, nd, 1), census_bound(cb9, nd)),
                    ("census_cost_windowed", lambda: sk.census_cost_volume_windowed(wcb9, wcm9, ws, dw),
                     census_bound(cb9, dw, 4 * ws.numel()))):
                log(f"time {name} {shape if name == 'census_cost' else wshape} {what}: kernel {cuda_ms(fn, 5):.3f} ms, "
                    f"bound {b_ms:.3f} ms ({b_by})")
        del cb9, cm9, wcb9, wcm9

        if tag == "slice":  # times at the main path's shapes
            timed = {
                "census_cost": (lambda: sk.census_cost_volume(cb, cm, nd, 1),
                                lambda: census_cost_volume(cb, cm, nd, 1), 5),
                "census_cost_windowed": (lambda: sk.census_cost_volume_windowed(cb, cm, ws, dw),
                                         lambda: census_cost_volume_windowed(cb, cm, ws, dw), 5),
                "sgm_wta_fused": (lambda: sk.sgm_wta_fused(cost, 8, 96, 8, 1, 1),
                                  lambda: plain_sgm.sgm_wta_fused_plain(cost, 8, 96, 8, 1, 1), 3),
                "sgm_wta_fused_windowed": (lambda: sk.sgm_wta_fused_windowed(wcost, ws, 8, 96, 8, 1),
                                           lambda: plain_sgm.sgm_wta_fused_windowed_plain(wcost, ws, 8, 96, 8, 1), 3),
                "sgm_aggregate": (lambda: sk.sgm_aggregate(cost, 8, 96, 8),
                                  lambda: plain_sgm.sgm_aggregate(cost, 8, 96, 8), 3),
                "sgm_aggregate_windowed": (lambda: sk.sgm_aggregate_windowed(wcost, ws, 8, 96, 8),
                                           lambda: plain_sgm.sgm_aggregate_windowed(wcost, ws, 8, 96, 8), 3),
                "label_propagate": (lambda: ck.propagate_labels(init, conn_v, conn_h, LABEL_ROUNDS),
                                    lambda: ck.propagate_labels_plain(init, conn_v, conn_h, LABEL_ROUNDS), 3),
            }
            n, nw, hw, nws = cost.numel(), wcost.numel(), base.numel(), 4 * ws.numel()
            for name, d, extra in (("census_cost", nd, 0), ("census_cost_windowed", dw, nws)):
                results[name]["bound_ms"], results[name]["bound_by"] = census_bound(cb, d, extra)
            set_bound(results, "sgm_wta_fused", n + 4 * hw, SGM_OPS * 8 * n)
            set_bound(results, "sgm_wta_fused_windowed", nw + nws + 4 * hw, SGM_OPS * 8 * nw)
            set_bound(results, "sgm_aggregate", 3 * n, SGM_OPS * 8 * n)
            set_bound(results, "sgm_aggregate_windowed", 3 * nw + nws, SGM_OPS * 8 * nw)
            # K7: labels and both masks in, labels out; 4 operations a pixel
            # and pass over the rounds this mask ran (the last one changes nothing).
            set_bound(results, "label_propagate", 10 * hw, 4 * 2 * min(label_rounds + 1, LABEL_ROUNDS) * hw)
            for name, (kernel, plain, reps) in timed.items():
                results[name]["ms"] = cuda_ms(kernel, reps)
                results[name]["plain_ms"] = cuda_ms(plain)
                log(f"time {name} {shape if 'windowed' not in name else wshape}: "
                    f"kernel {results[name]['ms']:.3f} ms, plain {results[name]['plain_ms']:.3f} ms, "
                    f"bound {results[name]['bound_ms']:.3f} ms")
        check_h2(results, tag, cost, wcost, ws, shape, wshape)
        del cost, wcost
        torch.cuda.empty_cache()
    return results


def c2f_line(wd: Path) -> str:
    for line in (wd / "wass_stereo_log.txt").read_text().splitlines():
        if "c2f window coverage:" in line:
            return line.split("[INFO] ", 1)[-1]
    return ""


def check_frame(i, wd: Path, scene, required, gate: bool) -> dict:
    """A reconstructed frame: outputs read back, kernels launched, error."""
    import numpy as np

    from wass_tpu_torch.testing import read_frame, trimmed_elevation_error

    plane, mesh, per_frame = read_frame(wd)
    missing = [k for k in required if per_frame.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"frame {i}: kernels not launched: {missing} ({per_frame})")
    if not np.all(np.isfinite(plane)):
        raise AssertionError(f"frame {i}: no plane (plane_ok false)")
    if mesh.shape[1] != 3 or len(mesh) < (0.5 if gate else 0.1) * W * H or not np.isfinite(mesh).all():
        raise AssertionError(f"frame {i}: mesh of shape {mesh.shape} is too small or not finite")
    err = trimmed_elevation_error(scene, mesh, plane)
    digests = ", ".join(f"{f} {hashlib.sha256((wd / f).read_bytes()).hexdigest()}" for f in ("mesh_cam.xyzC", "plane.txt"))
    log(f"frame {i} sha256: {digests}")
    log(f"frame {i}: {len(mesh)} points, plane {' '.join(f'{v:.6f}' for v in plane)}, "
        f"trimmed-mean elevation error {err:.5f} (gate {ELEVATION_GATE if gate else 'none'}), "
        f"{c2f_line(wd) or 'no c2f'}, launches {per_frame}")
    if gate and not err < ELEVATION_GATE:
        raise AssertionError(f"frame {i}: elevation error {err} >= {ELEVATION_GATE}")
    return per_frame


def run_main_path(seq: Path, scene) -> dict:
    """Phase 4: the stereo CLI over N_FRAMES workdirs, with checks."""
    import wass_tpu_torch
    from wass_tpu_torch.cli.main import main as cli_main

    wass_tpu_torch.reset_launch_counts()
    t0 = time.time()
    rc = cli_main(["stereo", str(seq)])
    wall = time.time() - t0
    launches = wass_tpu_torch.launch_counts()
    if rc != 0:
        raise AssertionError(f"stereo CLI returned {rc}")
    log(f"main path: {N_FRAMES} frames in {wall:.2f} s = {N_FRAMES / wall:.3f} frames/s "
        f"(PNG decode to .xyzC, first frame included); launches {launches}")

    wds = sorted(seq.glob("*_wd"))
    if len(wds) != N_FRAMES:
        raise AssertionError(f"expected {N_FRAMES} workdirs, found {len(wds)}")
    for i, wd in enumerate(wds):
        check_frame(i, wd, scene, WINDOWED_PATH, gate=True)
        if not c2f_line(wd).endswith("windowed"):
            raise AssertionError(f"frame {i} did not take the windowed branch: {c2f_line(wd)!r}")
    return launches


# Phase 4b: (name, config override, kernels the run must launch, c2f log
# line ending or None when c2f does not run).
BRANCHES = [
    ("fallback", {"c2f_min_coverage": 1.01}, ("census_cost", "sgm_wta_fused", "label_propagate"),
     "FALLBACK to full-range SGM"),
    ("full_range", {"c2f_window": 0}, ("census_cost", "sgm_wta_fused", "label_propagate"), None),
    ("lr_check", {"lr_max_diff": 1}, ("census_cost", "sgm_aggregate", "label_propagate"), None),
    # 2 paths over the windows; the guard is opened so that the frame takes
    # the windowed branch whatever the noisier 2-path coarse map gives.
    ("two_paths", {"directions": 2, "c2f_min_coverage": 0.0, "c2f_max_offband": 1.0},
     ("census_cost", "sgm_aggregate", "census_cost_windowed", "sgm_aggregate_windowed", "label_propagate"),
     "windowed"),
    # The 5-path set (cv::StereoSGBM's default) over the windows, after an
    # 8-path coarse pass, and at full range.
    ("five_paths", {"directions": 5},
     ("census_cost", "sgm_wta_fused", "census_cost_windowed", "sgm_wta_fused_windowed", "label_propagate"),
     "windowed"),
    ("full_range_5", {"directions": 5, "c2f_window": 0}, ("census_cost", "sgm_wta_fused", "label_propagate"), None),
]
GATED = ("fallback", "full_range")

# Phase 4c: (name, config override, the H2-off frame it must equal, kernels
# the run must launch, c2f log line ending or None).
H2_FRAMES = [
    ("h2_c2f", {}, "smoke_seq",
     ("census_cost", "census_cost_windowed", "sgm_pair_img", "sgm_tri_dir_partial_h2",
      "sgm_tri_dir_partial_windowed_h2", "sgm_walk", "label_propagate"), "windowed"),
    ("h2_five_paths", {"directions": 5}, "smoke_five_paths",
     ("census_cost", "census_cost_windowed", "sgm_pair_img", "sgm_tri_dir_partial_h2", "sgm_walk",
      "sgm_tri_dir_wta_windowed_h2", "label_propagate"), "windowed"),
    ("h2_full_range_5", {"directions": 5, "c2f_window": 0}, "smoke_full_range_5",
     ("census_cost", "sgm_pair_img", "sgm_tri_dir_wta_h2", "label_propagate"), None),
    ("h2_lr_check", {"lr_max_diff": 1}, "smoke_lr_check",
     ("census_cost", "sgm_pair_img", "sgm_walk", "label_propagate"), None),
]


def run_frame(root: Path, name: str, override: dict, required, c2f_end, img0, img1, rig, scene) -> dict:
    """One frame through SequencePipeline with a config override, checked;
    returns its launches (counts set to 0 just before it)."""
    import wass_tpu_torch
    from wass_tpu_torch.cli.main import load_pipeline
    from wass_tpu_torch.testing import write_sequence

    seq = root / f"smoke_{name}"
    write_sequence(seq, img0, img1, rig, 1)
    pipe = load_pipeline(seq)
    pipe.cfg.stereo = dataclasses.replace(pipe.cfg.stereo, **override)
    wass_tpu_torch.reset_launch_counts()
    t0 = time.time()
    pipe.stereo()
    launches = wass_tpu_torch.launch_counts()
    log(f"branch {name} {override}: {time.time() - t0:.2f} s; launches {launches}")
    wd = seq / "000000_wd"
    per_frame = check_frame(name, wd, scene, required, gate=name in GATED)
    if name == "fallback" and per_frame.get("label_propagate") != 2:
        # The writer's full-range re-run counts for its own frame: K7 runs
        # once in the windowed pass and once in the re-run.
        raise AssertionError(f"fallback frame: launches {per_frame}, expected label_propagate=2")
    line = c2f_line(wd)
    if (c2f_end is None and line) or (c2f_end is not None and not line.endswith(c2f_end)):
        raise AssertionError(f"branch {name}: c2f log line {line!r}, expected {c2f_end!r}")
    return launches


def same_outputs(a: Path, b: Path, what: str) -> None:
    for f in ("mesh_cam.xyzC", "plane.txt"):
        if (a / "000000_wd" / f).read_bytes() != (b / "000000_wd" / f).read_bytes():
            raise AssertionError(f"{what}: {f} differs")
    log(f"{what}: mesh_cam.xyzC and plane.txt byte-identical")


def add_counts(totals: dict, launches: dict) -> None:
    for k, v in launches.items():
        totals[k] = totals.get(k, 0) + v


def run_branches(root: Path, img0, img1, rig, scene) -> dict:
    """Phase 4b: one frame per branch through SequencePipeline."""
    totals = {}
    for name, override, required, c2f_end in BRANCHES:
        add_counts(totals, run_frame(root, name, override, required, c2f_end, img0, img1, rig, scene))
    same_outputs(root / "smoke_fallback", root / "smoke_full_range", "fallback frame vs the c2f_window = 0 frame")
    return totals


def run_h2_frames(root: Path, img0, img1, rig, scene) -> dict:
    """Phase 4c: the H2 frames, each against its H2-off frame."""
    totals = {}
    with h2_on():
        for name, override, reference, required, c2f_end in H2_FRAMES:
            launches = run_frame(root, name, override, required, c2f_end, img0, img1, rig, scene)
            default = [k for k in DEFAULT_SGM if launches.get(k, 0)]
            if default:
                raise AssertionError(f"{name}: the default SGM path ran with H2 on: {default}")
            add_counts(totals, launches)
            same_outputs(root / f"smoke_{name}", root / reference, f"{name} vs {reference} (H2 off)")
    return totals


def paeth_png(img8) -> bytes:
    """PNG bytes of an (H, W) uint8 image with the Paeth filter on every row
    (what libpng writers often choose), which the port's decoder
    reconstructs one anti-diagonal at a time."""
    import struct
    import zlib

    import numpy as np

    from wass_tpu_torch.io import png

    x = img8.astype(np.int32)
    a = np.pad(x, ((0, 0), (1, 0)))[:, :-1]
    b = np.pad(x, ((1, 0), (0, 0)))[:-1]
    c = np.pad(x, ((1, 0), (1, 0)))[:-1, :-1]
    raw = np.empty((x.shape[0], x.shape[1] + 1), np.uint8)
    raw[:, 0] = 4
    raw[:, 1:] = (x - png._paeth(a, b, c)) & 0xFF
    ihdr = struct.pack(">IIBBBBB", x.shape[1], x.shape[0], 8, 0, 0, 0, 0)
    return (png._SIGNATURE + png._chunk(b"IHDR", ihdr) + png._chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + png._chunk(b"IEND", b""))


def host_png_times(img8, root: Path) -> None:
    """Phase P: host ms of the port's PNG encode and decode at full size
    (filter-0 rows, the port's writer; Paeth rows), and Paeth decodes one
    after another against the prefetcher's 4 threads."""
    import numpy as np

    from wass_tpu_torch.io import png
    from wass_tpu_torch.io.prefetch import Prefetcher

    def host_ms(fn, reps=3):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        return (time.perf_counter() - t0) / reps * 1e3, out

    enc_ms, data = host_ms(lambda: png.encode_gray(img8))
    dec_ms, back = host_ms(lambda: png.decode_gray(data))
    paeth = paeth_png(img8)
    pdec_ms, pback = host_ms(lambda: png.decode_gray(paeth), 2)
    if not (np.array_equal(back, img8) and np.array_equal(pback, img8)):
        raise AssertionError("PNG round trip changed the image")
    log(f"host PNG {img8.shape[1]}x{img8.shape[0]}: encode {enc_ms:.1f} ms ({len(data)} bytes), decode filter-0 "
        f"{dec_ms:.1f} ms, decode Paeth {pdec_ms:.1f} ms ({len(paeth)} bytes)")
    paths = []
    for k in range(8):
        path = root / f"paeth_{k}.png"
        path.write_bytes(paeth)
        paths.append(path)
    t0 = time.perf_counter()
    for path in paths:
        png.read_gray(path)
    serial = time.perf_counter() - t0
    with Prefetcher(4) as pf:
        t0 = time.perf_counter()
        for t in [pf.submit(path) for path in paths]:
            pf.take(t)
        pooled = time.perf_counter() - t0
    log(f"host PNG: 8 Paeth decodes one after another {serial * 1e3:.1f} ms, on the 4-thread prefetcher "
        f"{pooled * 1e3:.1f} ms ({serial / pooled:.2f}x)")


def run_prepare(root: Path, rig, scene) -> dict:
    """Phase P: raw frames through a known lens -> `prepare` -> `genconfig`
    -> `stereo`, on the card, checked like phase 4; the device ms of
    undistort_image and clahe, the host ms of the PNG codec, prepare's
    frames/s; then one frame prepared with CLAHE through
    SequencePipeline.prepare, its elevation error printed, not gated."""
    import numpy as np
    import torch

    import wass_tpu_torch
    from wass_tpu_torch.cli.main import load_pipeline
    from wass_tpu_torch.cli.main import main as cli_main
    from wass_tpu_torch.io.png import read_gray
    from wass_tpu_torch.ops.sampling import undistort_image
    from wass_tpu_torch.prepare.clahe import clahe
    from wass_tpu_torch.testing import load_or_render_raw, read_frame, trimmed_elevation_error, write_raw_sequence

    t0 = time.time()
    raw = load_or_render_raw(rig, SCENE_SEED, *PREP_DIST, root)
    log(f"phase P: the scene through the lenses {PREP_DIST} ready in {time.time() - t0:.1f} s")
    t0 = time.time()
    cam0, cam1, calib = write_raw_sequence(root / "smoke_raw", *raw, rig, PREP_FRAMES, *PREP_DIST)
    log(f"phase P: {PREP_FRAMES} raw pairs written in {time.time() - t0:.2f} s")
    out = root / "smoke_prepared"
    if out.exists():
        shutil.rmtree(out)
    t0 = time.time()
    if cli_main(["prepare", str(cam0), str(cam1), str(calib), str(out)]) != 0:
        raise AssertionError("prepare CLI failed")
    wall = time.time() - t0
    log(f"prepare: {PREP_FRAMES} frames in {wall:.3f} s = {PREP_FRAMES / wall:.4f} frames/s "
        "(raw PNG decode, undistortion on the card, PNG encode and XML files)")
    if cli_main(["genconfig", str(out), "--stage", "stereo"]) != 0:
        raise AssertionError("genconfig failed")
    wass_tpu_torch.reset_launch_counts()
    if cli_main(["stereo", str(out)]) != 0:
        raise AssertionError("stereo CLI failed on the prepared frames")
    launches = wass_tpu_torch.launch_counts()
    for i, wd in enumerate(sorted(out.glob("*_wd"))):
        check_frame(f"prepared {i}", wd, scene, WINDOWED_PATH, gate=True)
        if not c2f_line(wd).endswith("windowed"):
            raise AssertionError(f"prepared frame {i} did not take the windowed branch: {c2f_line(wd)!r}")

    dev = torch.device("cuda")
    raw0 = read_gray(cam0 / "000000.png")
    x = torch.as_tensor(raw0.astype(np.float32), device=dev)
    K = torch.as_tensor(np.asarray(rig.K0, np.float32), device=dev)
    dist = torch.as_tensor(np.asarray(PREP_DIST[0], np.float32), device=dev)
    H, Wd = raw0.shape
    log(f"device per image {Wd}x{H}: undistort_image {cuda_ms(lambda: undistort_image(x, K, dist), 5):.3f} ms, "
        f"clahe ({H // CLAHE_TILE_PX}x{Wd // CLAHE_TILE_PX} tiles) "
        f"{cuda_ms(lambda: clahe(x, 2.0, tiles_x=Wd // CLAHE_TILE_PX, tiles_y=H // CLAHE_TILE_PX), 5):.3f} ms")
    host_png_times(raw0, root)

    # One frame with CLAHE, through SequencePipeline.prepare and the
    # options of prepare_config.txt.
    seq = root / "smoke_clahe"
    if seq.exists():
        shutil.rmtree(seq)
    seq.mkdir()
    (seq / "prepare_config.txt").write_text(
        f"CAM0_CLAHE_TILEGRIDSIZE={CLAHE_TILE_PX}\nCAM1_CLAHE_TILEGRIDSIZE={CLAHE_TILE_PX}\n")
    pipe = load_pipeline(seq)
    raw1 = read_gray(cam1 / "000000.png")
    t0 = time.time()
    pipe.prepare([(raw0.astype(np.float32), raw1.astype(np.float32))], rig.K0, PREP_DIST[0], rig.K1, PREP_DIST[1],
                 rig.R, rig.T)
    log(f"prepare with CLAHE ({pipe.cfg.prepare}): 1 frame in {time.time() - t0:.3f} s")
    wass_tpu_torch.reset_launch_counts()
    pipe.stereo()
    add_counts(launches, wass_tpu_torch.launch_counts())
    plane, mesh, _ = read_frame(seq / "000000_wd")
    err = trimmed_elevation_error(scene, mesh, plane) if np.all(np.isfinite(plane)) and len(mesh) else float("nan")
    log(f"frame clahe: {len(mesh)} points, trimmed-mean elevation error {err:.5f} (not gated: CLAHE changes the "
        f"images on purpose), {c2f_line(seq / '000000_wd') or 'no c2f'}")
    return launches


def iidyn_case(results: dict, what: str, A, x0, mask) -> int:
    """Phase M: the iidyn kernel against its plain version, which adds its
    sums in the kernel's order: capped at IIDYN_CAP updates, then both run
    to convergence (IIDYN_ITERS at most): the same update count, x and
    Nash error bit for bit, so the same group (x > 0.7 max x).  Returns
    the kernel's updates."""
    import torch

    from wass_tpu_torch.match import iidyn as im

    for cap in (IIDYN_CAP, IIDYN_ITERS):
        xk, itk, ek = im.iidyn(A, x0, mask, max_iters=cap)
        xp, itp, ep = im.iidyn_plain(A, x0, mask, max_iters=cap)
        itk = int(itk)
        err = float((xk - xp).abs().max())
        if itk != itp or not torch.equal(xk, xp) or not torch.equal(ek, ep):
            raise AssertionError(f"iidyn {what}: at most {cap} updates: kernel {itk}, plain {itp}, max |dx| {err}, "
                                 f"Nash error {float(ek)} and {float(ep)}")
        results["iidyn"]["max_abs_err"] = max(results["iidyn"]["max_abs_err"], err)
    group = xk > 0.7 * xk.max()
    log(f"kernel iidyn {what}: bit-equal to the plain version after {IIDYN_CAP} updates and at convergence "
        f"({itk} updates, Nash error {float(ek):.3g}, group of {int(group.sum())})")
    return itk


def planted_clique(C: int, g: int, seed: int, n_live: int, dev):
    """A (C, C) payoff of 0-0.05 noise, made on the card, with a g-clique
    of 0.9-1 and symmetric over the first n_live candidates, which are the
    live ones (the dynamics read no other entry of A); and the initial
    population over them."""
    import torch

    from wass_tpu_torch.match.iidyn import initial_population

    gen = torch.Generator(device=dev).manual_seed(seed)
    A = torch.rand((C, C), generator=gen, device=dev) * 0.05
    A[:g, :g] = 0.9 + 0.1 * torch.rand((g, g), generator=gen, device=dev)
    A[:n_live, :n_live] = ((A[:n_live, :n_live] + A[:n_live, :n_live].T) / 2).fill_diagonal_(0.0)
    live = torch.arange(C, device=dev) < n_live
    return A, initial_population(torch.rand(C, generator=gen, device=dev), live), live


def check_iidyn(results: dict, wd: Path, dev, card: str) -> int:
    """Phase M: iidyn on frame 0's first-round payoff (the matcher's AUTO
    budget at 2048x1536: 4000 features x 3 candidates) and on the
    cluster's edges (planted cliques), with the kernel's and the plain
    version's time for the frame's first round.  Returns its updates."""
    import torch

    from wass_tpu_torch.io.workdir import Workdir
    from wass_tpu_torch.match import iidyn as im
    from wass_tpu_torch.match.features import detect_features
    from wass_tpu_torch.match.matcher import generate_candidates, payoff_matrix
    from wass_tpu_torch.match.pipeline import MatchConfig
    from wass_tpu_torch.prepare.degradation import resolve_smooth_sigma
    from wass_tpu_torch.stereo.cost import gauss_blur

    cfg = MatchConfig(hessian_threshold=MATCH_HESSIAN)
    w = Workdir(wd)
    img0, img1 = w.load_undistorted(0), w.load_undistorted(1)
    sigma = resolve_smooth_sigma(cfg.input_smooth_sigma, img0, "match")
    f0, f1 = (detect_features(gauss_blur(torch.as_tensor(x, device=dev), sigma), max_features=4000, grid_cell=8,
                              hessian_threshold=cfg.hessian_threshold) for x in (img0, img1))
    log(f"frame 0 features (threshold {cfg.hessian_threshold:g}): {int(f0.valid.sum())} and {int(f1.valid.sum())} "
        "valid of 4000")
    cand = generate_candidates(f0, f1)
    pay = payoff_matrix(f0, f1, cand)
    C = pay.shape[0]
    # match_frame's first draws: row 0 of the rounds' uniforms.
    u = torch.rand((cfg.max_rounds, C), generator=torch.Generator(device=dev).manual_seed(cfg.seed), device=dev)[0]
    x0 = im.initial_population(u, cand.valid)
    n_live = int(cand.valid.sum())
    iters = iidyn_case(results, f"frame 0 round 0 (C = {C}, {n_live} live)", pay, x0, cand.valid)
    # The cluster's edges: a planted clique; 5 live of 3000 (11 of the 16
    # CTAs hold none); one live; C not a multiple of GROUPS x THREADS; the
    # largest C for which A takes 30% of the card's free memory (2000 live,
    # so that the run converges: an update moves one candidate).
    G, T = im.GROUPS, im.THREADS
    big = int((0.3 * torch.cuda.mem_get_info(dev)[0] / 4) ** 0.5)
    for what, c, n in (("planted 60-clique", 2000, 2000), ("5 live", 3000, 5), ("one live", 3000, 1),
                       (f"C = 2 x {G} x {T} + 13, a 60-clique", 2 * G * T + 13, 2000),
                       ("the largest C, a 60-clique", big, 2000)):
        A, cx0, live = planted_clique(c, 60, c + n, n, dev)
        iidyn_case(results, f"{what} (C = {c}, {n} live)", A, cx0, live)
        del A
    torch.cuda.empty_cache()

    res = results["iidyn"]
    res["ms"] = cuda_ms(lambda: im.iidyn(pay, x0, cand.valid, max_iters=IIDYN_ITERS), 3)
    res["plain_ms"] = cuda_ms(lambda: im.iidyn_plain(pay, x0, cand.valid, max_iters=IIDYN_ITERS))
    # The bound: every update must read the row of A at the live columns,
    # 4 n_live bytes; once, x, Ax and the diagonal at the live columns, the
    # mask, and x written for all C.  The whole row, 4 C bytes an update,
    # is printed beside it.
    set_bound(results, "iidyn", iters * 4.0 * n_live + 12.0 * n_live + 5.0 * C, 0.0)
    row_ms = bound(iters * 4.0 * C, 0.0)[0]
    plain200 = cuda_ms(lambda: im.iidyn_plain(pay, x0, cand.valid, max_iters=IIDYN_PLAIN_TIMED))
    log(f"time iidyn frame 0 round 0 (C = {C}, {n_live} live; cluster of {G} CTAs x {T} threads; {card}): kernel "
        f"{res['ms']:.3f} ms for {iters} updates ({1e3 * res['ms'] / max(iters, 1):.3f} us an update), plain "
        f"{res['plain_ms']:.3f} ms for the same round, plain {plain200:.3f} ms for {IIDYN_PLAIN_TIMED} updates "
        f"({1e3 * plain200 / IIDYN_PLAIN_TIMED:.1f} us an update), bound {res['bound_ms']:.4f} ms ({res['bound_by']}, "
        f"a share of {res['bound_ms'] / res['ms']:.4f}), whole rows (4 C bytes an update) {row_ms:.4f} ms "
        f"(a share of {row_ms / res['ms']:.4f})")
    del pay
    torch.cuda.empty_cache()
    return iters


@contextlib.contextmanager
def timed_stages(targets):
    """Replace each (module, attribute, label) function by a wrapper that
    synchronizes before and after the call and appends its device ms
    (CUDA events) to times[label]; iidyn's updates go to times["iidyn
    updates"].  The originals come back after the block."""
    import torch

    times: dict = {}
    saved = []
    for mod, attr, label in targets:
        fn = getattr(mod, attr)

        def timed(*args, _fn=fn, _label=label, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            out = _fn(*args, **kwargs)
            end.record()
            torch.cuda.synchronize()
            times.setdefault(_label, []).append(start.elapsed_time(end))
            if _label == "iidyn round":
                times.setdefault("iidyn updates", []).append(int(out[1]))
            return out

        setattr(mod, attr, timed)
        saved.append((mod, attr, fn))
    try:
        yield times
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def profile_match(seq: Path, rig) -> tuple:
    """Phase M, measurement only: the device ms of each stage of one
    match_frame on frame 0's pair and of one autocalibrate_sequence over the
    phase's workdirs (the host float64 polish in host ms).  Returns the
    match frame's iidyn rounds (ms, updates) and wall s."""
    from wass_tpu_torch.calib import autocalibrate as ac
    from wass_tpu_torch.io.workdir import Workdir, frame_workdirs
    from wass_tpu_torch.match import matcher
    from wass_tpu_torch.match import pipeline as mp

    cfg = mp.MatchConfig(hessian_threshold=MATCH_HESSIAN)
    w = Workdir(seq / "000000_wd")
    img0, img1 = w.load_undistorted(0), w.load_undistorted(1)
    stages = [(mp, "gauss_blur", "input smoothing, per image"), (mp, "detect_features", "features, per image"),
              (mp, "generate_candidates", "candidates"), (mp, "payoff_matrix", "payoff"),
              (matcher, "iidyn", "iidyn round"), (mp, "refine_matches_lk", "LK"),
              (mp, "relative_pose_ransac", "pose RANSAC + GN")]
    t0 = time.perf_counter()
    with timed_stages(stages) as times:
        mp.match_frame(img0, img1, rig.K0, rig.K1, cfg)
    wall = time.perf_counter() - t0
    for name, t in times.items():
        if name == "iidyn updates":
            continue
        vals = " ".join(f"{v:.3f}" for v in t)
        log(f"match stage {name}: {vals} ms" + (f" ({' '.join(map(str, times['iidyn updates']))} updates)"
                                               if name == "iidyn round" else ""))
    log(f"match_frame on frame 0: {wall:.3f} s wall, {len(times['iidyn round'])} rounds, "
        f"stage sum {sum(sum(t) for k, t in times.items() if k != 'iidyn updates'):.1f} ms")
    rounds = (sum(times["iidyn round"]), sum(times["iidyn updates"]), wall)
    res = mp.match_frame(img0, img1, rig.K0, rig.K1)
    log(f"match_frame on frame 0 with the default threshold ({mp.MatchConfig().hessian_threshold:g}; not gated): "
        + ("no pose" if res is None else f"{res.n_matches} pose-inlier matches, epipolar avg {res.epi_avg:.4f} px"))

    stages = [(ac, "relative_pose_ransac", "RANSAC + GN"), (ac, "lm_refine_two_view", "BA"),
              (ac, "lm_refine_pose_epipolar", "device polish round")]
    host: list = []
    f64 = ac.polish_pose_f64

    def timed_f64(*args, **kwargs):
        t = time.perf_counter()
        out = f64(*args, **kwargs)
        host.append(1e3 * (time.perf_counter() - t))
        return out

    ac.polish_pose_f64 = timed_f64
    t0 = time.perf_counter()
    try:
        with timed_stages(stages) as times:
            res = ac.autocalibrate_sequence(frame_workdirs(seq), ac.AutocalConfig())
    finally:
        ac.polish_pose_f64 = f64
    wall = time.perf_counter() - t0
    for name, t in times.items():
        log(f"autocalibrate stage {name}: {' '.join(f'{v:.3f}' for v in t)} ms")
    log(f"autocalibrate host float64 polish rounds: {' '.join(f'{v:.1f}' for v in host)} ms; "
        f"{wall:.3f} s wall ({res.n_inliers} pooled inliers; median px {res.epi_med_before:.5f} -> "
        f"{res.epi_med_after:.5f})")
    return rounds


def pose_error(wd, rig) -> tuple:
    """max |dR| and max |dT| (T normalized) of a workdir's extrinsics against the rig."""
    import numpy as np

    R, T = wd.load_extrinsics()
    return float(np.abs(R - rig.R).max()), float(np.abs(T.ravel() / np.linalg.norm(T) - rig.T / np.linalg.norm(rig.T)).max())


def run_pooled_scenes(root: Path, scene, dev) -> dict:
    """Phase M: POOL_SEEDS' scenes of the rig, one workdir each, through
    `match` and `autocalibrate`; the pooled pose against the rig (gated
    as a pooled pose), and the elevation error of the first scene's frame
    made with it (printed, not gated).  Returns the launches."""
    import wass_tpu_torch
    from wass_tpu_torch.cli.main import load_pipeline
    from wass_tpu_torch.cli.main import main as cli_main
    from wass_tpu_torch.io.workdir import Workdir, frame_workdirs
    from wass_tpu_torch.testing import WAVE_AMPLITUDE, write_pairs
    from wass_tpu_torch.testing.synthetic import render_pair

    t0 = time.time()
    rig = scene.rig
    pairs = [(scene.img0, scene.img1)] + [render_pair(seed, rig, dev, WAVE_AMPLITUDE) for seed in POOL_SEEDS[1:]]
    seq = root / "smoke_pool"
    write_pairs(seq, pairs, rig)
    for wd in seq.glob("*_wd"):
        (wd / "ext_R.xml").unlink()
        (wd / "ext_T.xml").unlink()
    (seq / "matcher_config.txt").write_text(f"FEATURE_HESSIAN_THRESHOLD={MATCH_HESSIAN}\n")
    log(f"pooled scenes {POOL_SEEDS}: rendered and written in {time.time() - t0:.1f} s")
    wass_tpu_torch.reset_launch_counts()
    if cli_main(["match", str(seq)]) != 0 or cli_main(["autocalibrate", str(seq)]) != 0:
        raise AssertionError("match or autocalibrate CLI failed on the pooled scenes")
    for seed, wd in zip(POOL_SEEDS, frame_workdirs(seq)):
        n, avg = (wd.path / "matcher_stats.csv").read_text().splitlines()[1].split(";")[:2]
        log(f"pooled scene {seed}: {n} pose-inlier matches, epipolar avg {float(avg):.4f} px (not gated)")
    wd0 = Workdir(seq / "000000_wd")
    d_r, d_t = pose_error(wd0, rig)
    _, _, max_dr, max_dt = MATCH_GATES
    log(f"pooled pose of {len(POOL_SEEDS)} distinct scenes against the rig: max |dR| {d_r:.3g} (gate {max_dr}), "
        f"max |dT| {d_t:.3g} (gate {max_dt}); "
        + (seq / "wass_autocalibrate_log.txt").read_text().strip().replace("\n", "; "))
    if not (d_r <= max_dr and d_t <= max_dt):
        raise AssertionError(f"pooled pose of the distinct scenes: |dR| {d_r}, |dT| {d_t}")
    load_pipeline(seq).stereo([wd0], progress_stream=io.StringIO())
    check_frame(f"pool 0 (scene {POOL_SEEDS[0]}, the pooled extrinsics)", wd0.path, scene, WINDOWED_PATH, gate=False)
    log(f"pooled scenes: {time.time() - t0:.1f} s")
    return wass_tpu_torch.launch_counts()


def run_match_phase(root: Path, scene, results: dict, dev, card: str) -> dict:
    """Phase M: the iidyn kernel check; then `match`, a stereo frame with
    the match stage's extrinsics, `autocalibrate` and a stereo frame with
    the pooled extrinsics, through the CLI's entry point and
    SequencePipeline on the card, gated (the two frames' elevation errors
    printed); then the stage times (not counted); then the pooled distinct
    scenes."""
    import numpy as np

    import wass_tpu_torch
    from wass_tpu_torch.cli.main import load_pipeline
    from wass_tpu_torch.cli.main import main as cli_main
    from wass_tpu_torch.io.workdir import Workdir, frame_workdirs
    from wass_tpu_torch.match import iidyn as im
    from wass_tpu_torch.testing import write_sequence

    t_phase = time.time()
    rig = scene.rig
    seq = root / "smoke_match"
    write_sequence(seq, scene.img0, scene.img1, rig, MATCH_FRAMES)
    for wd in seq.glob("*_wd"):  # no extrinsics: match and autocalibrate must find them
        (wd / "ext_R.xml").unlink()
        (wd / "ext_T.xml").unlink()
    (seq / "matcher_config.txt").write_text(f"FEATURE_HESSIAN_THRESHOLD={MATCH_HESSIAN}\n")
    iters = check_iidyn(results, seq / "000000_wd", dev, card)
    wd0 = Workdir(seq / "000000_wd")

    def stereo_frame0(what: str, gate: bool) -> None:
        t0 = time.time()
        load_pipeline(seq).stereo([wd0], progress_stream=io.StringIO())
        log(f"stereo of frame 0 with the {what}: {time.time() - t0:.2f} s")
        check_frame(f"match 0 ({what})", wd0.path, scene, WINDOWED_PATH, gate=gate)
        if not c2f_line(wd0.path).endswith("windowed"):
            raise AssertionError(f"the frame with the {what} did not take the windowed branch: {c2f_line(wd0.path)!r}")

    min_matches, max_epi, max_dr, max_dt = MATCH_GATES
    wass_tpu_torch.reset_launch_counts()
    t0 = time.time()
    if cli_main(["match", str(seq)]) != 0:
        raise AssertionError("match CLI failed")
    t_match = time.time() - t0
    wds = frame_workdirs(seq)
    for i, wd in enumerate(wds):
        n, avg = (wd.path / "matcher_stats.csv").read_text().splitlines()[1].split(";")[:2]
        wall = [ln for ln in (wd.path / "wass_match_log.txt").read_text().splitlines() if "wall time" in ln]
        d_r, d_t = pose_error(wd, rig)
        log(f"match frame {i}: {n} pose-inlier matches, epipolar avg {float(avg):.4f} px, its pose max |dR| {d_r:.3g} "
            f"max |dT| {d_t:.3g}, {wall[0].split('] ')[-1]}")
        if int(n) < min_matches or not float(avg) <= max_epi or not (d_r <= max_dr and d_t <= max_dt):
            raise AssertionError(f"match frame {i}: {n} matches, {avg} px, |dR| {d_r}, |dT| {d_t} (gates {MATCH_GATES})")
    for name in ("matches.txt", "matches_epionly.txt", "matches_unfiltered.txt"):
        data = [(wd.path / name).read_bytes() for wd in wds]
        if any(d != data[0] for d in data[1:]):
            raise AssertionError(f"{name} differs across the frames of one pair")
    log("match files: matches.txt, matches_epionly.txt, matches_unfiltered.txt byte-identical across the frames")
    stereo_frame0("match stage's extrinsics", gate=False)

    t0 = time.time()
    if cli_main(["autocalibrate", str(seq)]) != 0:
        raise AssertionError("autocalibrate CLI failed")
    t_autocal = time.time() - t0
    log((seq / "wass_autocalibrate_log.txt").read_text().strip().replace("\n", "; "))
    d_r, d_t = pose_error(wd0, rig)
    log(f"pooled pose against the rig: max |dR| {d_r:.3g} (gate {max_dr}), max |dT| {d_t:.3g} (gate {max_dt})")
    if not (d_r <= max_dr and d_t <= max_dt):
        raise AssertionError(f"pooled pose: |dR| {d_r}, |dT| {d_t}")
    R, T = wd0.load_extrinsics()
    for wd in wds[1:]:
        if any(not np.array_equal(a, b) for a, b in zip(wd.load_extrinsics(), (R, T))):
            raise AssertionError(f"{wd.path.name}: extrinsics differ from frame 0's")
    stereo_frame0("pooled extrinsics", gate=False)
    launches = wass_tpu_torch.launch_counts()
    log(f"phase M: match {MATCH_FRAMES} frames {t_match:.2f} s ({t_match / MATCH_FRAMES:.2f} s a frame), "
        f"autocalibrate {t_autocal:.2f} s; launches {launches}")
    if launches["iidyn"] < 1:
        raise AssertionError(f"phase M launched no iidyn kernel: {launches}")
    rounds_ms, updates, wall = profile_match(seq, rig)
    add_counts(launches, run_pooled_scenes(root, scene, dev))
    res = results["iidyn"]
    log(f"iidyn on {card}, a cluster of {im.GROUPS} CTAs x {im.THREADS} threads: frame 0 round 0 {res['ms']:.3f} ms "
        f"({1e3 * res['ms'] / max(iters, 1):.3f} us an update), the match frame's 20 rounds {rounds_ms:.3f} ms "
        f"({updates} updates, {1e3 * rounds_ms / max(updates, 1):.3f} us an update), match_frame wall {wall:.3f} s")
    log(f"phase M: {time.time() - t_phase:.1f} s wall")
    return launches


def dispatch_syncs(img0, img1, rig, cfg) -> list:
    """Phase 5: the operations that make the dispatching thread wait for the
    device, in one c2f frame dispatched as the sequence loop dispatches it
    (deferred fallback), under torch.cuda.set_sync_debug_mode("warn")."""
    import warnings

    import numpy as np
    import torch

    from wass_tpu_torch.device import to_device
    from wass_tpu_torch.stereo import dense

    dev = torch.device("cuda")
    H, W = img0.shape
    geom = dense.prepare_frame_geometry(rig.K0, rig.K1, rig.R, rig.T, (W, H))
    gp = dense.build_geom_pack(geom, (H, W), dev)
    pipe = dense.DenseStereoPipeline(cfg, defer_c2f_fallback=True)
    b8, m8 = (np.clip(np.asarray(x), 0, 255).astype(np.uint8) for x in
              ((img0, img1) if geom.base_is_cam0 else (img1, img0)))

    def dispatch():
        b = to_device(torch.from_numpy(b8), dev).float()
        m = to_device(torch.from_numpy(m8), dev).float()
        return pipe(dense.rectify_on_device(b, gp["H_base"], (H, W)), dense.rectify_on_device(m, gp["H_match"], (H, W)), gp)

    dispatch()
    torch.cuda.synchronize()
    # Switched on before the recording starts: the switch warns once itself.
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            dispatch()
            host_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    sites = [f"{Path(w.filename).name}:{w.lineno}" for w in caught if "synchroniz" in str(w.message)]
    log(f"dispatch of one c2f frame: {len(sites)} host syncs {sites}; host {host_ms:.1f} ms (with the sync checks)")
    return sites


def profile_c2f_frame(root: Path, img0, img1, rig) -> None:
    """Phase 5: the c2f frame's device stages and the sequence loop's rate."""
    import numpy as np
    import torch

    from wass_tpu_torch.cli.main import load_pipeline
    from wass_tpu_torch.ops import components_kernels as ck
    from wass_tpu_torch.stereo import dense
    from wass_tpu_torch.stereo.c2f import coarse_disparity, compute_row_windows, windowed_disparity
    from wass_tpu_torch.stereo.cost import census_transform
    from wass_tpu_torch.testing import write_sequence

    seq = root / "smoke_loop"
    write_sequence(seq, img0, img1, rig, LOOP_FRAMES)
    for depth, writers in LOOP_SETTINGS:
        pipe = load_pipeline(seq)
        pipe.cfg.dispatch_depth, pipe.cfg.writer_threads = depth, writers
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rates, decode, dispatch = [], [], []
        for _ in range(3):
            t0 = time.time()
            pipe.stereo(progress_stream=io.StringIO())  # returns after the last frame's files are written
            rates.append(LOOP_FRAMES / (time.time() - t0))
            decode += pipe.loop_stats["decode_s"]
            dispatch += pipe.loop_stats["dispatch_s"]
        log(f"sequence loop (dispatch_depth {depth}, writer_threads {writers}): {LOOP_FRAMES} frames a pass, "
            f"frames/s {' '.join(f'{r:.4f}' for r in rates)} (PNG decode to .xyzC written; the first pass "
            f"includes the warm-up); PNG decode on the prefetch threads {1e3 * np.mean(decode):.1f} ms an image "
            f"(max {1e3 * max(decode):.1f}); dispatch on the main thread {1e3 * np.mean(dispatch):.1f} ms a frame "
            f"(max {1e3 * max(dispatch):.1f}); peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    cfg = pipe.cfg.stereo  # the AUTO smoothing resolved by the loop
    dispatch_syncs(img0, img1, rig, cfg)
    dev = torch.device("cuda")
    H, W = img0.shape
    geom = dense.prepare_frame_geometry(rig.K0, rig.K1, rig.R, rig.T, (W, H))
    gp = dense.build_geom_pack(geom, (H, W), dev)
    b8, m8 = (np.clip(np.asarray(x), 0, 255).astype(np.uint8) for x in
              ((img0, img1) if geom.base_is_cam0 else (img1, img0)))
    times: dict = {}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def stage(name, fn):
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.setdefault(name, []).append(start.elapsed_time(end))
        return out

    def windows(disp_c):
        ws, cov, offband = compute_row_windows(disp_c, cfg.c2f_factor, cfg.num_disp, cfg.min_disp, cfg.c2f_window)
        torch.stack([cov, offband]).tolist()  # the frame's host decision point
        return ws

    for _ in range(3):
        b, m = stage("upload (uint8 H2D + cast)", lambda: (torch.as_tensor(b8).to(dev).float(),
                                                         torch.as_tensor(m8).to(dev).float()))
        base, match = stage("rectify", lambda: (dense.rectify_on_device(b, geom.H_base, (H, W)),
                                               dense.rectify_on_device(m, geom.H_match, (H, W))))
        cb, cm = stage("census, both images", lambda: (census_transform(base, cfg.census_win, cfg.input_smooth_sigma),
                                                       census_transform(match, cfg.census_win, cfg.input_smooth_sigma)))
        disp_c = stage("coarse pass (pool, census, K1, K3)", lambda: coarse_disparity(
            base, match, cfg.num_disp, cfg.min_disp, cfg.p1, cfg.p2, cfg.directions, cfg.census_win,
            cfg.uniqueness_ratio, cfg.c2f_factor))
        ws = stage("windows + host read", lambda: windows(disp_c))
        disp = stage("K2 + K4 (Dw = 128)", lambda: windowed_disparity(
            cb, cm, ws, cfg.c2f_window, cfg.p1, cfg.p2, cfg.directions, cfg.uniqueness_ratio))
        disp = stage("postprocess", lambda: dense.disparity_postprocess(disp, cfg))
        pts, valid, _ = stage("triangulate", lambda: dense.triangulate_dense(disp, gp, base, match, cfg))
        keep, _ = stage("outlier removal (z-gap bisection + K7)", lambda: dense.outlier_removal(pts, valid, cfg))
        k7_rounds = ck.rounds_changed()
        plane, _, valid_f = stage("plane (RANSAC + refine)", lambda: dense.plane_stage(pts, valid & keep, cfg))
        stage("export + D2H", lambda: [t.cpu() for t in dense.export_u16(pts, valid_f, plane)])
    for name, t in times.items():
        log(f"stage {name}: {min(t):.3f}-{max(t):.3f} ms")
    sums = [sum(t[i] for t in times.values()) for i in range(3)]
    log(f"stage sum: {min(sums):.3f}-{max(sums):.3f} ms; K7 on the frame's z-gap mask: {k7_rounds} of "
        f"{LABEL_ROUNDS} rounds changed labels")

GRID_AREA = 16.0  # phase G's --area_size (m) about frame 0's median point: every cell inside the footprint
GRID_MIN_FINITE = 0.5  # the share of finite cells each of phase G's modes must give
GRID_MODES = (  # phase G's other modes, one frame each: (label, setup options, grid options)
    ("N = 512", ["-N", "512"], []),
    ("IDW", [], ["--ia", "IDW"]),
    ("--filter-outliers", [], ["--filter-outliers"]),
    ("-mf 3", [], ["-mf", "3"]),
    ("LinearND, 10% of the points", [], ["--ia", "LinearND", "--subsample", "10"]),
    ("--force-zero-mean", [], ["--force-zero-mean"]),
)


@contextlib.contextmanager
def grid_timers():
    """Phase G: each grid stage function wrapped with a synchronize before
    and after; times[label] gets (device ms from CUDA events, host ms) a
    call.  The slabs that push_Z writes are kept in times["slabs"]."""
    import numpy as np
    import torch

    from wass_tpu_torch.grid import gridding, netcdf

    times: dict = {"slabs": []}
    targets = [(gridding, "load_mesh", "mesh load (host read, upload, decode)"),
               (gridding, "align_mesh", "binning: sea-plane transform"), (gridding, "bin_points", "binning: cells"),
               (gridding, "_median_stack", "median stack (10 draws)"), (gridding, "dct_interpolate", "DCT fit"),
               (netcdf.NetCDFWriter, "push_Z", "slab write (push_Z)")]
    saved = []
    for owner, attr, label in targets:
        fn = getattr(owner, attr)

        def timed(*args, _fn=fn, _label=label, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            out = _fn(*args, **kwargs)
            end.record()
            torch.cuda.synchronize()
            times.setdefault(_label, []).append((start.elapsed_time(end), 1e3 * (time.perf_counter() - t0)))
            if _fn.__name__ == "push_Z":
                times["slabs"].append(np.array(args[1], np.float32))
            return out

        setattr(owner, attr, timed)
        saved.append((owner, attr, fn))
    try:
        yield times
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def grid_cli(seq: Path, out: Path, *options) -> float:
    """wass-tpu-torch-gridsurface on the card; its wall seconds."""
    from wass_tpu_torch.cli.gridsurface import main as grid_main

    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = grid_main([str(seq), str(out), *options])
    if rc != 0:
        raise AssertionError(f"gridsurface {' '.join(options)} exited {rc}")
    return time.time() - t0


def stack_inputs(wd, setup, device) -> tuple:
    """The median stack's inputs for a frame on device: (px, py, z, good, shape)."""
    from wass_tpu_torch.grid import gridding

    ma = gridding.align_mesh(gridding.load_mesh(wd.path / "mesh_cam.xyzC", device), setup)
    px, py, good = gridding.bin_points(ma, setup)
    return px, py, ma[2].float(), good, setup.XX.shape


def dct_coeffs(Irec, nf: int):
    """The DCT coefficients behind a reconstruction (float64; the basis is
    orthonormal)."""
    from wass_tpu_torch.grid.interpolators import _dct_matrix

    H, W = Irec.shape
    return _dct_matrix(H)[:nf] @ Irec.astype("float64") @ _dct_matrix(W)[:nf].T


def height_errors(scene, cam) -> tuple:
    """(RMS, median |dz|) in meters of cam0-frame points (3, N), meters,
    against the scene's wave field at the same world x, y."""
    import numpy as np

    rig = scene.rig
    w = rig.R0.T @ (cam - rig.T0.reshape(3, 1))
    dz = w[2] - scene.waves.eta(w[0], w[1])
    return float(np.sqrt(np.mean(dz**2))), float(np.median(np.abs(dz)))


def grid_errors(scene, setup, Z, cells=None) -> str:
    """The gridded surface's height errors over its finite cells (of
    `cells` when given): grid node -> sea-plane frame -> cam0 -> world."""
    import numpy as np

    ok = np.isfinite(Z) if cells is None else np.isfinite(Z) & cells
    p = np.stack([setup.XX[ok], setup.YY[ok], -Z[ok]]) / setup.baseline
    rms, med = height_errors(scene, setup.Rpl.T @ (p - setup.Tpl) * setup.baseline)
    return f"RMS {rms:.5f} m, median |dz| {med:.5f} m"


def run_grid_phase(root: Path, scene, card: str) -> None:
    """Phase G: the grid stage on phase 5's frames (2048x1536, c2f)."""
    import numpy as np
    import torch

    from wass_tpu_torch.grid import gridding
    from wass_tpu_torch.grid.interpolators import dct_loss, dct_x0
    from wass_tpu_torch.grid.netcdf import NetCDFReader
    from wass_tpu_torch.grid.setup import GridSetup, align_on_sea_plane
    from wass_tpu_torch.io import png
    from wass_tpu_torch.io.workdir import frame_workdirs

    t_phase = time.time()
    seq, out = root / "smoke_loop", root / "smoke_grid"
    shutil.rmtree(out, ignore_errors=True)
    wds = frame_workdirs(seq)
    mesh = wds[0].load_mesh_cam()
    plane = np.nanmean(np.loadtxt(seq / "output" / "planes.txt", ndmin=2), axis=0)
    ma = align_on_sea_plane(mesh, plane) * scene.rig.baseline
    cx, cy = np.median(ma[:2], axis=1)
    area = ["--baseline", str(scene.rig.baseline), "--area_center", f"{cx:.3f},{cy:.3f}", "--area_size",
            str(GRID_AREA), "--fps", "4"]
    t_setup = grid_cli(seq, out, "--action", "setup", *area)
    setup = GridSetup.load_mat(out / "config.mat")
    log(f"phase G: setup {t_setup:.2f} s ({len(wds)} frames of {mesh.shape[1]} points; area {GRID_AREA} m about "
        f"({cx:.2f}, {cy:.2f}), N = {setup.XX.shape[0]})")

    # The grid over every frame, timed by stage, then again untimed.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with grid_timers() as times:
        t_grid = grid_cli(seq, out, "--action", "grid")
    peak = torch.cuda.max_memory_allocated() / 2**30
    with NetCDFReader(out / "gridded.nc") as cube:
        Z1 = cube.Z[...]
    t_grid2 = grid_cli(seq, out, "--action", "grid")
    cube_bytes = (out / "gridded.nc").stat().st_size
    with NetCDFReader(out / "gridded.nc") as cube:
        Zc = cube.Z[...]
        n = len(wds)
        if Zc.shape != (n, setup.XX.shape[1], setup.XX.shape[0]):
            raise AssertionError(f"phase G: cube Z {Zc.shape} for {n} frames of {setup.XX.shape}")
        if Z1.tobytes() != Zc.tobytes():
            raise AssertionError("phase G: two grid runs gave different Z bytes")
        if Z1.tobytes() != np.stack(times["slabs"]).transpose(0, 2, 1).tobytes():
            raise AssertionError("phase G: Z does not read back as the pushed grids")
        if not (np.array_equal(cube["count"][...], np.arange(n))
                and np.array_equal(cube["time"][...], (np.arange(n) / 4.0).astype(np.float32))
                and np.array_equal(cube["workdir"][...], np.arange(n))):
            raise AssertionError("phase G: count, time or workdir do not read back")
        image = cube["cam0images"][0]
        if not np.array_equal(png.decode_gray(image.tobytes()), png.read_gray(wds[0].undistorted_path(0))):
            raise AssertionError("phase G: cam0images[0] is not the undistorted frame")
    log(f"phase G: grid {n} frames (DCT, 500 iterations, nreps 10) {t_grid:.2f} s with the stage syncs, "
        f"{t_grid2:.2f} s without: {t_grid2 / n:.3f} s a frame; two runs byte-identical Z; the cube reads back "
        f"({cube_bytes} bytes, {len(image)} bytes of PNG a frame); peak device memory {peak:.2f} GiB")
    for label, t in times.items():
        if label != "slabs":
            dev_ms, host_ms = np.array(t).T
            log(f"phase G stage {label}: device {dev_ms.mean():.3f} ms (min {dev_ms.min():.3f}, max "
                f"{dev_ms.max():.3f}), host {host_ms.mean():.3f} ms, {len(t)} calls")
    log(f"phase G: grid times on {card}")

    # Frame 0 on the card and on the CPU, with the same draws.
    t0 = time.time()
    cfg = gridding.GridConfig()
    dev_in, cpu_in = stack_inputs(wds[0], setup, "cuda"), stack_inputs(wds[0], setup, "cpu")
    if not all(torch.equal(a.cpu(), b) for a, b in zip(dev_in[:4], cpu_in[:4])):
        raise AssertionError("phase G: the card's bins or z differ from the CPU's")
    npts = dev_in[0].shape[0]
    perms = gridding.median_draws(npts, cfg.nreps, npts, cfg.seed, "cuda")
    zs_dev = gridding._median_stack(*dev_in, cfg.nreps, npts, perms)
    zs_cpu = gridding._median_stack(*cpu_in, cfg.nreps, npts, perms.cpu())
    # Bit-equal where finite, NaN at the same cells (CUDA's arithmetic
    # returns its canonical NaN, so NaN bits differ from the CPU's).
    zs_dev = zs_dev.cpu()
    finite = torch.isfinite(zs_cpu)
    if not (torch.equal(torch.isfinite(zs_dev), finite)
            and torch.equal(zs_dev[finite].view(torch.int32), zs_cpu[finite].view(torch.int32))):
        raise AssertionError("phase G: the card's median stack differs from the CPU's")
    x0 = dct_x0(min(cfg.dct_nfreqs, *setup.XX.shape), cfg.seed, "cuda")
    zd, _ = gridding.grid_frame(wds[0], setup, cfg, device="cuda", perms=perms, x0=x0)
    zc, _ = gridding.grid_frame(wds[0], setup, cfg, device="cpu", perms=perms.cpu(), x0=x0.cpu())
    zd, zc = zd.cpu().numpy(), zc.numpy()
    # tests/test_torch_grid.py::test_dct_matches_jax's tolerance: the cells
    # with data within 0.1% of Z's range, the holes (where the fit only
    # extrapolates) within 1%, the final loss within 1e-4 relative.
    obs = finite.numpy()
    zrange = float(np.nanmax(zc) - np.nanmin(zc))
    diff = np.abs(zd - zc)
    err_obs, err_hole = float(diff[obs].max()), float(diff[~obs].max()) if (~obs).any() else 0.0
    zs = np.nan_to_num(zs_cpu.numpy())
    ld, lc = (dct_loss(torch.as_tensor(z), torch.as_tensor(zs), finite.float(),
                       torch.as_tensor(dct_coeffs(z, x0.shape[0])), cfg.dct_alpha) for z in (zd, zc))
    if not (np.isfinite(zd).all() and err_obs <= 1e-3 * zrange and err_hole <= 1e-2 * zrange
            and abs(ld - lc) <= 1e-4 * abs(lc)):
        raise AssertionError(f"phase G: DCT fit card vs CPU: {err_obs} m at the cells with data, {err_hole} m in "
                             f"the holes (Z range {zrange} m; gates 0.1% and 1%), losses {ld} and {lc}")
    log(f"phase G: frame 0 on the card and on the CPU with the same draws: median stack bit-equal "
        f"({100 * float(obs.mean()):.1f}% of the cells hit); DCT surface within {err_obs:.3g} m at the cells with "
        f"data, {err_hole:.3g} m in the holes (Z range {zrange:.3g} m; gates 0.1% and 1%), losses {ld:.9g} "
        f"(card) and {lc:.9g} (CPU) ({time.time() - t0:.1f} s)")
    inside = (np.abs(ma[0] - cx) <= GRID_AREA / 2) & (np.abs(ma[1] - cy) <= GRID_AREA / 2)
    rms, med = height_errors(scene, mesh[:, inside] * scene.rig.baseline)
    log(f"phase G: frame 0's heights against the wave field at the same world x, y (printed, not gated): the "
        f"gridded Z over the mask (every cell) {grid_errors(scene, setup, zd)}; over the cells with data "
        f"{grid_errors(scene, setup, zd, obs)}; over the holes {grid_errors(scene, setup, zd, ~obs)}; the median "
        f"stack {grid_errors(scene, setup, zs_cpu.numpy())}; the mesh's {int(inside.sum())} points in the area "
        f"RMS {rms:.5f} m, median |dz| {med:.5f} m")

    # The other modes, one frame each.
    one = root / "smoke_grid_one"
    shutil.rmtree(one, ignore_errors=True)
    one.mkdir()
    (one / wds[0].path.name).symlink_to(wds[0].path.resolve())
    for label, setup_opts, grid_opts in GRID_MODES:
        mout = root / "smoke_grid_mode"
        shutil.rmtree(mout, ignore_errors=True)
        if setup_opts:
            grid_cli(one, mout, "--action", "setup", *area, *setup_opts)
        else:
            grid_opts = ["--gridsetup", str(out / "config.mat"), *grid_opts]
        t = grid_cli(one, mout, "--action", "grid", *grid_opts)
        with NetCDFReader(mout / "gridded.nc") as cube:
            Z = cube.Z[...]
        if not np.isfinite(Z).mean() > GRID_MIN_FINITE:
            raise AssertionError(f"phase G {label}: {np.isfinite(Z).mean():.3f} of the cells finite")
        log(f"phase G mode {label}: one frame {t:.2f} s, Z {Z.shape}, {100 * np.isfinite(Z).mean():.1f}% finite")
    log(f"phase G: {time.time() - t_phase:.1f} s wall")


POST_FRAMES = 3000  # phase S's cube: 200 s at 15 Hz (users film 10-30 min at 10-20 Hz; the cut is the duration)
POST_FPS = 15.0
POST_CHECK_FRAMES = 8  # the slab of the march's first kernel-vs-plain gate
HM0 = 1.0  # the wave field's significant height: 4 x std(eta), WaveField.random scales std(eta) to the amplitude 0.25
HM0_GATE = 0.10  # phase S's relative gate on spectrum's Hm0
MARCH_BYTES_PER_RAY = 4 + 12 + 1  # Z read, d read, the flag written


def post_cube(path: Path, setup, scene, n_frames: int, fps: float, dev) -> None:
    """Phase S's cube: phase G's grid and meta, Z the scene's wave field
    (mm) at the grid nodes' world x, y (the node on the sea plane -> cam0 ->
    world) and t = i / fps, evaluated on the device in float64."""
    import numpy as np
    import torch

    from wass_tpu_torch.grid.netcdf import NetCDFWriter

    H, W = setup.XX.shape
    p = np.stack([setup.XX.ravel(), setup.YY.ravel(), np.zeros(setup.XX.size)]) / setup.baseline
    cam = setup.Rpl.T @ (p - setup.Tpl) * setup.baseline
    world = scene.rig.R0.T @ (cam - scene.rig.T0.reshape(3, 1))
    wx, wy = (torch.as_tensor(world[i], dtype=torch.float64, device=dev) for i in (0, 1))
    waves = scene.waves
    w = NetCDFWriter(path, M=H, N=W, count=n_frames)
    try:
        w.scale = setup.baseline
        w.set_grids(setup.XX * 1000.0, setup.YY * 1000.0)
        w.set_kxky(setup.KX_ab, setup.KY_ab)
        w.set_intrinsics(setup.K0, setup.K1, np.zeros(5), np.zeros(5), setup.P0plane, setup.P1plane,
                         setup.P0cam[:3], setup.P1cam[:3], setup.Cam0toGrid, setup.Cam1toGrid)
        w.add_meta_attribute("generator", "wass_tpu")
        w.add_meta_attribute("baseline", setup.baseline)
        w.add_meta_attribute("fps", fps)
        w.set_mask(np.ones((H, W), np.float32))
        for t0 in range(0, n_frames, 100):
            t = torch.arange(t0, min(t0 + 100, n_frames), dtype=torch.float64, device=dev)[:, None] / fps
            eta = torch.zeros((t.shape[0], wx.shape[0]), dtype=torch.float64, device=dev)
            for a, kx, ky, ph in zip(waves.amps, waves.kx, waves.ky, waves.phases):
                eta += a * torch.cos(kx * wx + ky * wy + ph - np.sqrt(9.81 * np.hypot(kx, ky)) * t)
            for i, z in enumerate((eta * 1000.0).reshape(-1, H, W).cpu().numpy()):
                w.push_Z(z, time=(t0 + i) / fps, workdir=t0 + i)
    finally:
        w.close()


@contextlib.contextmanager
def post_timers(targets):
    """Phase S: each (owner, attr, label) of targets wrapped with CUDA
    events (its device ms: events around a call of device work on device
    tensors), and the port's dataset reads and writes with the host clock;
    times[label] gets a list of ms."""
    import torch

    from wass_tpu_torch.io import hdf5

    times: dict = {}
    saved = []

    def device_timed(fn, label):
        def timed(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            end.synchronize()
            times.setdefault(label, []).append(start.elapsed_time(end))
            return out
        return timed

    def host_timed(fn, label):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            times.setdefault(label, []).append(1e3 * (time.perf_counter() - t0))
            return out
        return timed

    wrapped = [(owner, attr, device_timed(getattr(owner, attr), label)) for owner, attr, label in targets]
    wrapped += [(hdf5.H5Dataset, "__getitem__", host_timed(hdf5.H5Dataset.__getitem__, "host reads")),
                (hdf5.H5Dataset, "__setitem__", host_timed(hdf5.H5Dataset.__setitem__, "host writes"))]
    for owner, attr, fn in wrapped:
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, fn)
    try:
        yield times
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def post_cli(args, targets=(), dev="cuda") -> tuple:
    """One wass-tpu-torch-post command; (its stdout, seconds, times by
    label, peak device MiB, bytes the cube grew)."""
    import torch

    from wass_tpu_torch.cli.post import main as post_main

    nc = Path(args[1])
    size = nc.stat().st_size
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    with post_timers(targets) as times, contextlib.redirect_stdout(out):
        t0 = time.time()
        rc = post_main([*args, "--device", str(dev)])
        torch.cuda.synchronize()
        secs = time.time() - t0
    if rc != 0:
        raise AssertionError(f"post {' '.join(args)} exited {rc}: {out.getvalue()}")
    return out.getvalue(), secs, times, torch.cuda.max_memory_allocated() / 2**20, nc.stat().st_size - size


def log_post(name: str, secs: float, times: dict, peak: float, grown: int, extra: str = "") -> None:
    import numpy as np

    parts = [f"{k} {np.sum(v):.1f} ms in {len(v)} calls" for k, v in times.items()]
    log(f"phase S {name}: {secs:.2f} s; {'; '.join(parts) or 'no device stage, no dataset read or write'}; peak "
        f"device memory {peak:.1f} MiB; the cube grew {grown} bytes{extra}")


def check_march(results: dict, Z_mm, grids: dict, cam_mm, dev, card: str) -> None:
    """Phase S, gate 1: the visibility march against its plain version on
    the card, bit-equal: an 8-frame slab of the cube (as the command lays
    it out, and with x along the columns), frame 0 with a NaN hole (its
    maxz NaN, and again with the nanmax so that its rays march), and a
    whole slab of the visibilitymap command (timed, kernel and plain)."""
    import numpy as np
    import torch

    from wass_tpu_torch.post import geometry as pg
    from wass_tpu_torch.post import visibility_kernels as vk

    XX, YY = grids["XX"], grids["YY"]
    dx = abs(XX[0, 1] - XX[0, 0]) or abs(XX[1, 0] - XX[0, 0])
    inv = 1.0 / dx

    def inputs(z_mm, cam_m=cam_mm):
        Z = torch.as_tensor(np.asarray(z_mm, np.float64) / 1000.0 * inv, dtype=torch.float32, device=dev)
        cam = torch.as_tensor(np.asarray(cam_m, np.float64) * inv, dtype=torch.float32, device=dev)
        rays = pg.view_rays(Z, cam, torch.as_tensor(XX * inv, dtype=torch.float32, device=dev),
                            torch.as_tensor(YY * inv, dtype=torch.float32, device=dev))
        return Z, pg.ray_steps(rays), Z.amax(dim=(1, 2)), 2 * max(Z.shape[1:])

    def same(what, Z, d, maxz, steps):
        occ = vk.march(Z, d, maxz, steps)
        _record(results, "visibility_march", occ, vk.march_plain(Z, d, maxz, steps), what)
        return occ

    Z, d, maxz, steps = inputs(Z_mm[:POST_CHECK_FRAMES])
    occ = same(f"{POST_CHECK_FRAMES}-frame slab {tuple(Z.shape)}", Z, d, maxz, steps)
    share = 100 * occ.float().mean().item()
    # The same frames with x along the columns (the cube stores (count, X,
    # Y), so the command's rays step x along Y, as the JAX command's do):
    # rays that march over the waves.
    XX, YY = XX.T, YY.T
    Zt = np.ascontiguousarray(Z_mm[:POST_CHECK_FRAMES].transpose(0, 2, 1))
    Z, d, maxz, steps = inputs(Zt)
    occ = same(f"{POST_CHECK_FRAMES}-frame slab, x along the columns", Z, d, maxz, steps)
    # And a camera 0.5 m above the grid's plane: grazing rays that the waves
    # occlude, marching up to the grid's edge.
    low = np.array([cam_mm[0], cam_mm[1], 0.5])
    Z, d, maxz, steps = inputs(Zt, low)
    graze = same(f"{POST_CHECK_FRAMES}-frame slab, x along the columns, the camera 0.5 m up", Z, d, maxz, steps)
    ms = cuda_ms(lambda: vk.march(Z, d, maxz, steps), reps=5)
    log(f"phase S march: {share:.2f}% of the slab's cells occluded by the march as the command lays the cube out, "
        f"{100 * occ.float().mean().item():.2f}% with x along the columns, {100 * graze.float().mean().item():.2f}% "
        f"with the camera 0.5 m up ({ms:.3f} ms for its {Z.numel()} rays)")
    XX, YY = XX.T, YY.T
    hole = np.array(Z_mm[:1], np.float32)
    H, W = hole.shape[1:]
    hole[0, H // 3:H // 3 + 9, W // 2:W // 2 + 13] = np.nan
    Z, d, maxz, steps = inputs(hole)
    occ = same("frame 0 with a NaN hole (maxz NaN)", Z, d, maxz, steps)
    if occ.any():
        raise AssertionError("phase S march: a frame whose maxz is NaN occluded a cell")
    nanmax = torch.where(torch.isnan(Z), torch.full_like(Z, -1e30), Z).amax(dim=(1, 2))
    occ = same("frame 0 with a NaN hole (its nanmax)", Z, d, nanmax, steps)
    if occ[torch.isnan(Z)].any():
        raise AssertionError("phase S march: a ray from a NaN cell occluded its cell")
    # A whole slab of the command (the budget's 8 bytes a cell), timed.
    from wass_tpu_torch.post.ooc import iter_time_slabs

    ts = next(iter(iter_time_slabs(Z_mm.shape, 8)))
    Z, d, maxz, steps = inputs(Z_mm[ts])
    same(f"a visibilitymap slab {tuple(Z.shape)}", Z, d, maxz, steps)
    r = results["visibility_march"]
    r["ms"] = cuda_ms(lambda: vk.march(Z, d, maxz, steps), reps=5)
    r["plain_ms"] = cuda_ms(lambda: vk.march_plain(Z, d, maxz, steps))
    set_bound(results, "visibility_march", MARCH_BYTES_PER_RAY * Z.numel(), 0)
    log(f"phase S march on a {tuple(Z.shape)} slab ({Z.numel()} rays, {steps} steps at most): kernel {r['ms']:.3f} ms, "
        f"plain {r['plain_ms']:.1f} ms, bound {r['bound_ms']:.4f} ms ({MARCH_BYTES_PER_RAY} bytes a ray at 3.35 TB/s), "
        f"on {card}")


def run_post_phase(root: Path, scene, results: dict, card: str, dev="cuda", n_frames: int = POST_FRAMES,
                   fps: float = POST_FPS) -> dict:
    """Phase S: the post console on a cube of phase G's grid (N = 256) and
    the scene's wave field over n_frames frames, then the radiance family on
    phase G's ten-frame cube.  Returns the visibilitymap run's launches."""
    import numpy as np
    import torch

    import wass_tpu_torch
    from wass_tpu_torch.grid.setup import GridSetup
    from wass_tpu_torch.io import hdf5
    from wass_tpu_torch.post import geometry, spectra
    from wass_tpu_torch.post import radiance as prad
    from wass_tpu_torch.post.ooc import streaming_time_mean

    t_phase = time.time()
    out = root / "smoke_post"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    setup = GridSetup.load_mat(root / "smoke_grid" / "config.mat")
    nc = out / "post.nc"
    t0 = time.time()
    post_cube(nc, setup, scene, n_frames, fps, dev)
    with hdf5.H5File(nc) as f:
        Z_mm = f["Z"][...]
        stored = {"XX": f["X_grid"][...] / 1000.0, "YY": f["Y_grid"][...] / 1000.0}
        C = f["meta"]["Cam0toGrid"][...] @ np.array([0.0, 0, 0, 1])
    log(f"phase S: cube of {n_frames} frames x {Z_mm.shape[1]} x {Z_mm.shape[2]} at {fps} Hz written in "
        f"{time.time() - t0:.1f} s ({nc.stat().st_size} bytes; Z {Z_mm.nbytes} bytes against a budget of "
        f"{int(os.environ.get('WASS_POST_MEMORY_MB', '512'))} MiB)")

    # Gate 1: the march's kernel against its plain version (no main-path counts).
    check_march(results, Z_mm, stored, C[:3] / C[3], dev, card)
    del Z_mm

    fft = torch.fft
    s = str(nc)
    res, secs, times, peak, grown = post_cli(["info", s], dev=dev)
    log_post("info", secs, times, peak, grown, f" ({len(res.splitlines())} lines)")
    res, secs, times, peak, grown = post_cli(["spectrum", s, "--nperseg", "512", "--rangespan", "5"],
                                             [(fft, "rfft", "device rfft")], dev)
    fr, S = np.loadtxt(nc.with_suffix(".spectrum.csv"), delimiter=";").T
    st = spectra.spectrum_stats(fr, S)
    log_post("spectrum", secs, times, peak, grown, f": Hm0 {st.hm0:.4f} m (the field's {HM0} m), Tm01 {st.tm01:.3f} s, "
             f"Tp {st.tp:.3f} s")
    # Gate 3: Hm0; gate 4: the card's spectrum against the port's CPU run.
    if abs(st.hm0 - HM0) > HM0_GATE * HM0:
        raise AssertionError(f"phase S: spectrum Hm0 {st.hm0} m, not within {HM0_GATE:.0%} of {HM0} m")
    with hdf5.H5File(nc) as f:
        fc, Sc, _ = spectra.compute_spectrum(f["Z"], dt=1.0 / fps, nperseg=512, rangespan=5, scale=1e-3, device="cpu")
        fd, Sd, _ = spectra.compute_spectrum(f["Z"], dt=1.0 / fps, nperseg=512, rangespan=5, scale=1e-3, device=dev)
    err = float(np.abs(Sd - Sc).max() / Sc.max())
    if not (np.array_equal(fd, fc) and np.array_equal(fr, fc) and err <= 1e-5 and np.abs(S - Sd).max() <= 1e-5 * Sc.max()):
        raise AssertionError(f"phase S: the card's spectrum differs from the CPU's by {err} of max S (gate 1e-5)")
    log(f"phase S spectrum: card against CPU within {err:.3g} of max S (gate 1e-5, tests/test_torch_post.py)")
    res, secs, times, peak, grown = post_cli(["spectrum3d", s, "--segments", "10"],
                                             [(fft, "fftn", "device fftn"), (fft, "fftshift", "device fftshift")], dev)
    with np.load(nc.with_suffix(".spectrum3d.npz")) as z:
        shape3d = z["S"].shape
        if not np.isfinite(z["S"]).all():
            raise AssertionError("phase S: spectrum3d S is not finite")
    log_post("spectrum3d", secs, times, peak, grown, f": S {shape3d}")
    res, secs, times, peak, grown = post_cli(["filter", s], dev=dev)
    log_post("filter (lowpass 1 Hz, host scipy)", secs, times, peak, grown)
    res, secs, times, peak, grown = post_cli(["spatial_lowpass", s], [(fft, "fft2", "device fft2"),
                                                                       (fft, "ifft2", "device ifft2")], dev)
    log_post("spatial_lowpass", secs, times, peak, grown)
    res, secs, times, peak, grown = post_cli(["zeromean", s], dev=dev)
    log_post("zeromean", secs, times, peak, grown)
    with hdf5.H5File(nc) as f:
        resid = float(np.nanmax(np.abs(streaming_time_mean(f["Z"]))))
    if not resid < 1e-3:  # gate 5
        raise AssertionError(f"phase S: after zeromean the time mean reaches {resid} mm (gate 1e-3)")
    log(f"phase S zeromean: |time mean| at most {resid:.3g} mm afterwards (gate 1e-3)")
    res, secs, times, peak, grown = post_cli(["clip", s, "--zmin", "-600", "--zmax", "600"], dev=dev)
    log_post("clip", secs, times, peak, grown)
    new_fps = 2 * fps
    res, secs, times, peak, grown = post_cli(["setfps", s, str(new_fps)], dev=dev)
    log_post("setfps", secs, times, peak, grown)

    def sha(name):
        with hdf5.H5File(nc) as f:
            h = hashlib.sha256()
            for ts in range(0, f[name].shape[0], 500):
                h.update(f[name][ts:ts + 500].tobytes())
            return h.hexdigest()

    before = sha("Z_filtered")
    wass_tpu_torch.reset_launch_counts()
    res, secs, times, peak, grown = post_cli(
        ["visibilitymap", s], [(geometry, "visibility_device_batch", "device visibility (rays, incidence, march)"),
                               (geometry, "march", "device march kernel")], dev)
    launches = wass_tpu_torch.launch_counts()
    slab_ms = np.array(times["device march kernel"])
    log_post("visibilitymap", secs, times, peak, grown,
             f": {launches['visibility_march']} launches of the march, {slab_ms.mean():.3f} ms a slab (min "
             f"{slab_ms.min():.3f}, max {slab_ms.max():.3f}); {res.strip()}")
    if sha("Z_filtered") != before:
        raise AssertionError("phase S: visibilitymap changed Z_filtered")
    res, secs, times, peak, grown = post_cli(["renamevar", s, "Z_slp", "Z_lp"], dev=dev)
    log_post("renamevar", secs, times, peak, grown)

    # Gate 2: every output read back with the JAX command's names, shapes and dtypes.
    T, H, W = n_frames, setup.XX.shape[1], setup.XX.shape[0]
    want = {"Z": "float32", "Z_filtered": "float32", "Z_lp": "float32", "occlusion_cam0": "uint8",
            "incident_angles_cam0": "float32"}
    with hdf5.H5File(nc) as f:
        for name, dt in want.items():
            if f[name].shape != (T, H, W) or str(f[name].dtype) != dt:
                raise AssertionError(f"phase S: {name} {f[name].shape} {f[name].dtype}")
        if "Z_slp" in f or f["Z_filtered"].attrs["frequency_filter_cutoff"] != 1.0 or f["meta"].attrs["fps"] != new_fps:
            raise AssertionError("phase S: renamevar, the filter's cutoff or setfps did not read back")
        if not np.array_equal(f["time"][...], (np.arange(T) / new_fps).astype(np.float32)):
            raise AssertionError("phase S: setfps's time does not read back")
        occ_share = float(np.mean([f["occlusion_cam0"][t0:t0 + 500].mean() for t0 in range(0, T, 500)]))
        if np.abs(f["Z"][::97]).max() > 600:
            raise AssertionError("phase S: Z not clipped to [-600, 600]")
    log(f"phase S: every output reads back ({', '.join(want)}; Z_slp renamed Z_lp; fps {new_fps}); "
        f"{100 * occ_share:.2f}% of the cells occluded; Z_filtered unchanged by visibilitymap (sha256 {before[:16]})")

    # The radiance family on phase G's ten-frame cube (its PNG cam0images).
    gnc = str(root / "smoke_grid" / "gridded.nc")
    res, secs, times, peak, grown = post_cli(["radiance", gnc], [(prad, "bilinear_sample", "device bilinear sample")],
                                             dev)
    log_post("radiance (phase G's cube)", secs, times, peak, grown)
    for args in (["bgimage", gnc], ["radiance_threshold", gnc], ["radiance_threshold", gnc, "--use-vats"]):
        res, secs, times, peak, grown = post_cli(args, dev=dev)
        log_post(" ".join(args[:1] + args[2:]), secs, times, peak, grown)
    with hdf5.H5File(gnc) as f:
        n = f["Z"].shape[0]
        for name, dt in (("radiance_cam0", "float32"), ("radiance_bgimage_cam0", "float32"),
                         ("radiance_thresholded_cam0", "uint8")):
            if f[name].shape != f["Z"].shape or str(f[name].dtype) != dt:
                raise AssertionError(f"phase S: {name} {f[name].shape} {f[name].dtype}")
        rad = f["radiance_cam0"][...]
        if not (np.isfinite(rad).all() and 0 <= rad.min() and rad.max() <= 1 and rad.mean() > 0):
            raise AssertionError("phase S: radiance outside [0, 1] or empty")
    log(f"phase S radiance: {n} frames, mean {rad.mean():.4f}, {100 * np.mean(rad > 0):.1f}% of the cells seen")
    log(f"phase S: post times on {card}")
    log(f"phase S: {time.time() - t_phase:.1f} s wall")
    return launches


def main() -> int:
    t_start = time.time()
    if not (ROOT / "wass_tpu_torch").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository (wass_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    # Whole-volume plain versions beside the kernels' outputs: let the
    # allocator grow segments rather than fragment (up to 20 GB otherwise).
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2

    # Phase 1: the card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"torch device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda})")

    # Phase 2: build.
    from wass_tpu_torch import _build
    from wass_tpu_torch.device import require_cuda

    dev = require_cuda()
    t0 = time.time()
    lib_path, build_log = _build.build()
    _build.load()
    log(f"build: {lib_path.name} in {time.time() - t0:.1f} s")
    if build_log:
        (_build.BUILD_DIR / "ptxas.log").write_text(build_log)
        spills = [ln.strip() for ln in build_log.splitlines() if re.search(r"[1-9][0-9]* bytes spill", ln)]
        log(f"ptxas report in {_build.BUILD_DIR / 'ptxas.log'}; lines with spills: {spills[:8]}")

    from wass_tpu_torch.testing import load_or_make_scene, write_sequence

    t0 = time.time()
    scene = load_or_make_scene(W, H, SCENE_SEED, _build.BUILD_DIR)
    img0, img1, rig = scene.img0, scene.img1, scene.rig
    log(f"scene: {W}x{H} seed {SCENE_SEED} ready in {time.time() - t0:.1f} s")

    # Phase 3: kernels vs plain, on the rectified slice pair.
    from wass_tpu_torch.stereo.dense import prepare_frame_geometry, rectify_on_device

    geom = prepare_frame_geometry(rig.K0, rig.K1, rig.R, rig.T, (W, H))
    b_img, m_img = (img0, img1) if geom.base_is_cam0 else (img1, img0)
    rect = (
        rectify_on_device(torch.as_tensor(b_img, device=dev), geom.H_base, (H, W)).cpu(),
        rectify_on_device(torch.as_tensor(m_img, device=dev), geom.H_match, (H, W)).cpu(),
    )
    results = check_kernels(rect, dev)

    # Phase 4: the main path; 4b: the other branches; 4c: the H2 frames.
    seq = _build.BUILD_DIR / "smoke_seq"
    write_sequence(seq, img0, img1, rig, N_FRAMES)
    launches = run_main_path(seq, scene)
    for phase in (run_branches, run_h2_frames):
        add_counts(launches, phase(_build.BUILD_DIR, img0, img1, rig, scene))
    # Phase P: prepare on the card, then stereo on the prepared frames.
    add_counts(launches, run_prepare(_build.BUILD_DIR, rig, scene))
    # Phase M: match and autocalibrate on the card, then stereo with the recovered extrinsics.
    add_counts(launches, run_match_phase(_build.BUILD_DIR, scene, results, dev, smi))

    # Phase 5: where the c2f frame's time goes.
    profile_c2f_frame(_build.BUILD_DIR, img0, img1, rig)
    # Phase G: the grid stage on phase 5's frames.
    run_grid_phase(_build.BUILD_DIR, scene, smi)
    # Phase S: the post stage on a cube of phase G's grid.
    add_counts(launches, run_post_phase(_build.BUILD_DIR, scene, results, smi))
    unused = [k for k in KERNELS if launches[k] < 1]
    if unused:
        raise AssertionError(f"kernels no main-path run launched: {unused}")

    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": src,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": results[name]["max_abs_err"],
            "ms": results[name]["ms"],
            "plain_ms": results[name]["plain_ms"],
            "bound_ms": results[name]["bound_ms"],
            "bound_by": results[name]["bound_by"],
            "library_ms": None,
        }
        for name, (src, replaces) in KERNELS.items()
    ]
    log(f"chip_smoke.py: {time.time() - t_start:.1f} s wall")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
