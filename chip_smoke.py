#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (wass_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero:

1. The card: `nvidia-smi` name and power limit, torch's device name; and
   OpenCV's version and codec lines (phase I's first check: the PNG, JPEG
   and TIFF codecs must be there).
2. Build the CUDA kernels from wass_tpu_torch/csrc with nvcc (sm_90a), one
   nvcc per source, all started together; ptxas's register and spill
   report lands in wass_tpu_torch/_build/ptxas.log.
3. Each kernel against its plain PyTorch version on the card, bit-equal,
   with times from CUDA events at the slice's shapes: the rectified
   2048x1536 pair, D = 640 and 8 paths for K1/K3/K5/K7; Dw = 128 over the
   window starts of the pair's coarse pass for K2/K4/K6; the coarse pass's
   K1 and K3 (384x512, D = 160) timed too; K1 and K2 also over a 9x9
   census (3 words), at both shapes.  The census kernel on each image of
   the pair (sigma 0.8), on the coarse pass's pooled images (384x512,
   sigma 0) and over the 9x9 window, timed at the first two shapes (its
   launches queued behind a device sleep, so the host's call does not
   pace them) beside its byte bound and the plain version.  K7 also on a
   2048x1536 serpentine mask (bands every 4 rows joined at alternating
   ends) that no 24 rounds make converge, where all 24 rounds must change
   labels; the rounds that did work are printed for both masks.  Then at a
   ragged shape: 1001x777, D = 52 for K1/K3/K5/K7, and 1000x776, Dw = 52
   with random window starts (flat, rising, falling, jumps of >= Dw) for
   K2/K4/K6.  The five H2 kernels (the JAX package's _USE_H2 pieces) and
   the single non-H2 walks of the H2 compositions (sgm_walk) the same way,
   on the same volumes and on the coarse pass's (384x512, D = 160, with
   K1 and K3 there too), with their times; and the four public SGM entry
   points with sgm_kernels._USE_H2 set, bit-equal to their default path
   (5 and 8 paths), timed both ways at the slice's shapes.  Then the JPEG
   kernel (csrc/jpeg.cu) on one 5 MP frame's six debug renders in one
   call, each file byte-equal to OpenCV's and the plain version's, its
   device time beside its bound, and OpenCV's and the plain version's host
   times for the same images.
4. The main path: a synthetic 2048x1536 wave-field pair (rendered once and
   cached in wass_tpu_torch/_build/) written as 3 frame workdirs, then
   `python -m wass_tpu_torch.cli.main stereo <outdir>`'s entry point with
   the stereo defaults (MAX_DISPARITY = 640, the coarse-to-fine window of
   128), through the production loop (PNG prefetch threads, 3 frames
   dispatched ahead, 2 writer threads, the c2f fallback resolved by the
   writers).  Every frame must take the windowed branch, give a plane.txt and
   a mesh_cam.xyzC that read back through the workdir contract
   (wass_tpu_torch.testing.read_frame), a trimmed-mean elevation error
   below 0.02 baseline units, and must have launched the census kernel,
   K1, K2, K3, K4 and K7.  Every frame (here and in 4b, 4c) prints the
   sha256 of its mesh_cam.xyzC and plane.txt, so that runs of two commits
   on one card compare byte for byte.  Every frame also carries the six debug renders
   (phase I checks them).
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
   device ms of undistort_image and clahe per image (CUDA events), then one
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
   mask.  The loop runs with its debug renders on (the default) and off,
   and prints the writers' render ms a frame.  Measurement only: nothing here is counted as a launch of the
   main path.
F. The optical flow (phase F): FLOW_FRAMES of phase 5's frames through
   SequencePipeline with ENABLE_OPTICAL_FLOW=true (the flow defaults: 8
   linearisations and 200 Jacobi sweeps, the loop's defaults, renders on).
   Gates: each workdir's flow_coarse.png and flow.png decode to (1536,
   2048, 3); mesh_full_flow.ply's vertex count equals the frame's valid
   flow pixels; mesh_cam.xyzC and plane.txt byte-equal to phase 5's frame
   with the flow off; each frame launched 8 flow_linearize and 200
   flow_jacobi; the flow points' trimmed-mean elevation error (the worst
   0.1% dropped, tests/test_flow.py) under FLOW_GATE = 0.05, the point
   count printed.  Then frames/s with the flow against phase 5's with it
   off; frame 0's flow stage by stage on the loop's own inputs (CUDA
   events: coarse flow, opening, the IDW fill, the image gradients, the 8
   linearisations and 200 sweeps timed launch by launch, gates and
   triangulation; host ms of the two renders and the PLY write), the
   result equal to the loop's bit for bit; flow_linearize and
   flow_jacobi against their plain versions on frame 0's inputs (the
   first linearisation's, the second sweep's: u apart from the warp point,
   as in 24 of a warp's 25 sweeps)
   (bit-equal), timed, with their bounds; the whole solver through the
   kernels against the plain versions' loop on the card (bit-equal), both
   timed.
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
   cam0images[0] the undistorted frame as a quality-90 JPEG; frame 0 on the card
   and on the CPU with the same draws: the bins equal, the median stack
   bit-equal, the DCT fit within tests/test_torch_grid.py's tolerance.
   Printed, not gated: the RMS of frame 0's gridded Z against the scene's
   wave field.  Then one frame each of GRID_MODES (N = 512, IDW, the
   outlier votes, -mf 3, LinearND at 10%, the zero-mean rewrite), each
   giving more than GRID_MIN_FINITE finite cells; the outlier votes' frame
   twice, gated on the same Z bytes.  Then the votes on frame 0's points:
   twice on the card (gated equal, timed) and once on the CPU (the share
   of votes that differ printed).  Then --refine: frame 0's gridded Z
   refined (400 Adam steps) eagerly and through the CUDA graph of the step
   (capture, then replays), twice more by the graph: the two replays'
   bits equal, Z finite exactly inside the mask; printed: the eager and
   graph times against a step's bound, the loss at step 0 and after step
   400, the mean |dZ| inside the mask; then --refine through the console
   on one frame.  The setup's area_grid.png and the second grid run's
   gridded.png (drawn with OpenCV from fetched arrays) decode to 1200 x
   1200 and 800 x 800 RGB and equal a re-render on the host from the
   arrays the console drew them from; their draw and PNG ms are printed.
S. The post stage (phase S) on a cube of phase G's grid and meta (N = 256,
   its config.mat, P0plane and Cam0toGrid): POST_FRAMES frames at POST_FPS
   (200 s; users film 10-30 min at 10-20 Hz, the cut is the duration), Z
   the scene's wave field (mm) at the grid nodes' world x, y, written by
   the port's NetCDFWriter (786 MB of Z, over the 512 MB default budget,
   so every streaming path runs).  First the fused visibility kernel and
   the march-only kernel against their plain versions, bit-equal (occ,
   and inc's bits with NaN at the same cells): an 8-frame slab as
   visibilitymap lays the cube out, with x along the columns, with a
   camera 0.5 m above the plane (grazing rays that march) and with one
   over the grid's middle; two frames with a NaN hole in frame 0 (its max
   NaN; the march-only kernel also with the nanmax).  Then, timed, whole
   slabs: the command's 341 frames, the same frames with x along the
   columns and the camera 0.5 m up, and an N = 512 slab of the same area
   (85 frames) both ways: the fused kernel's ms and its plain version's,
   the bound and share, the steps the rays took (the plain march counts
   them) and the steps a ns, and the march-only kernel's ms on the same
   rays.  Then
   `wass-tpu-torch-post` through its entry point: info, spectrum (nperseg
   512, rangespan 5), spectrum3d (10 segments), filter (lowpass 1 Hz),
   spatial_lowpass, zeromean, clip, setfps, visibilitymap over every frame
   toward cam 0, renamevar; and on phase G's ten-frame cube (its JPEG
   cam0images) radiance, bgimage and radiance_threshold with and without
   --use-vats, then radiance from the workdirs' PNG frames (--wassdir),
   its difference from the JPEG run printed.  Each command prints its seconds, the device ms of its
   device stages (CUDA events around the FFTs, the bilinear sample, the
   visibility batch), the host ms of its dataset reads and writes, the
   peak device memory and the bytes the cube grew; visibilitymap also its
   launches, ms a slab and the share occluded, and again with the plain
   version on the card.  Then compute_occlusion_mask (the march-only
   kernel's main path) on OCCLUSION_FRAMES frames along a low sun.
   Gates: every output read back with the JAX command's names, shapes and
   dtypes, Z_filtered unchanged by visibilitymap (sha256); spectrum's Hm0
   within 10% of the field's 1.0 m; the card's spectrum within 1e-5 of
   max S of the port's CPU run on the same patch; after zeromean |time
   mean| < 1e-3 mm at every finite cell; visibilitymap's occlusion_cam0
   and incident_angles_cam0 byte-equal between the fused kernel's run and
   the plain version's; the occlusion masks equal to the CPU's; spectrum's
   post.spectrum.png 1200 x 720 RGB and equal to its host re-render (draw
   and PNG ms printed).
H. HDF5 layouts (phase H, after phase S): every file of
   tests/torch_h5_fixtures/ (written by h5py, tests/torch_h5_fixtures.py;
   this host has no h5py) read through the port's reader with every
   sha256 of its MANIFEST.json matched (deflate, shuffle, fletcher32, a
   filter mask, the version 4 chunk indexes, dense links and attributes,
   a committed VLEN type), LZF and scale-offset refused with their ids.
   The host ms and decoded MB/s of reading each fixture whole, dataset by
   dataset, and of the filter pipeline on one chunk of the reference's
   size (512 x 128 x 128 float32, shuffle and deflate level 4).  Then
   `wass-tpu-torch-post` info, spectrum (its plot), visibilitymap (the
   fused visibility kernel on the card) and zeromean on a copy of the
   netCDF-C-like cube and on its copy_to_port_layout copy: the same
   stdout (the conversion line aside), the same spectrum CSV and PNG bytes
   and, after the edits, the same digest of every dataset and attribute.
I. Image IO and the renders.  Phase 4's frames must carry the six stereo
   renders and phase M's matched frames the two match renders, each
   decoding to its shape; frame 0's render images from the card (kept while
   the loop ran) must be bit-equal to the same functions on the CPU over
   the same fetched tensors.  After phase S: the scene's 2048x1536 frame as
   PNG with each of the five row filters and as cv2.imencode writes it,
   each decoded bit-equal by the numpy codec and by OpenCV (ms an image
   for each), the port's filter-0 encode, and 8 filter-0 and 8 Paeth
   decodes one after another against the 4-thread prefetcher; phase P's
   raw pairs again as colour PNG (R = G = B), 16-bit PNG (x 257),
   quality-95 JPEG and float32 TIFF through `prepare` and `stereo` (the
   lossless forms must give phase P's undistorted PNGs, mesh_cam.xyzC and
   plane.txt byte for byte; the JPEG frames' elevation error is printed
   beside the 0.02 gate); phase 5's frames through the demosaic prepare
   with save_stokes (frame 0's TIFFs read back bit-equal to the card's
   Stokes images), then `polarimetric_setup` over phase G's cube, the
   finite share of its averages printed (no physics gate).
D. The frame-sharded path (phase D, after phase I).  (a) One process in
   an NCCL group of world size 1, a frame mesh of 2 slots on cuda:0, each
   slot dispatching its frames (frame i on slot i % 2) from a thread of
   its own: `SequencePipeline.stereo` over phase 5's ten frames with the
   defaults and the renders (two passes, frames/s beside phase 5's (3, 2)
   renders-on rate; two slots on one card are a record of overlap on one
   device, not a scaling number).  Every frame must launch what a
   one-slot c2f frame launches (WINDOWED_PATH), take the windowed branch,
   pass the elevation gate; its mesh_cam.xyzC and plane.txt, and
   output/planes.txt, must be byte-equal to phase 5's frames, and its
   wass_stereo_log.txt equal to phase 5's but for the wall time line.  A
   2-frame sequence on the 2 slots with frame 1's c2f fallback forced in
   the writers (c2f_should_fallback patched as cli/pipeline.py and
   stereo/dense.py see it): that frame re-runs at full range (K7 twice),
   byte-equal to phase 4b's c2f_window = 0 frame, and frame 0 to phase
   5's.  lm_refine_two_view_sharded over the 2 slots on phase M's pooled
   matches against the unsharded BA (float32: R and T's direction within
   5e-5, |T| printed; float64: 1e-10).  (b) Two processes on the card
   (this script with --sharded-rank, a localhost TCP store, gloo: NCCL
   refuses two ranks on one device), one slot each: the same ten frames
   through stereo(), each rank writing its own frames and rank 0
   planes.txt, all byte-equal to (a)'s; then the BA across the two ranks
   against (a)'s.  (c) With more than one card, a frame on the last card
   bit-equal to cuda:0's (one card: a line says the check needs two).
6. A JSON line of per-kernel results (times, launches, and the bound: the
   larger of the bytes the function must move, each input read once and
   each output written once, at 3.35 TB/s, and its integer operations at
   67 T/s, and for K1/K2 their popcounts at 16 a clock per SM at the
   maximum SM clock nvidia-smi reports; iidyn's is its updates' rows of A
   at the live columns, 4 n_live bytes each; the fused visibility
   kernel's 9 bytes a cell (Z in, occ and inc out) and XX, YY, its ~60
   float operations a cell and 13 a march step; the march-only kernel's
   17 bytes a ray (Z, d and the flag) and 13 operations a step; the flow
   kernels' 40 bytes a pixel each (flow_linearize, flow_jacobi); no
   single PyTorch call
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
import inspect
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
JPEG_DCT_OPS = 16 * 58  # integer operations of a block's islow DCT: 16 one-dimensional passes of 58
JPEG_FRAME = (1920, 2560)  # phase 3's JPEG frame: the 5 MP design point
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
    # Not a Pallas kernel: the XLA fusion of the census transform and its
    # pre-blur (features.py:_gauss_blur), one kernel an image.
    "census": ("wass_tpu_torch/csrc/census.cu", "wass_tpu/stereo/cost.py:27"),
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
    # Not Pallas kernels: the visibility batch's whole jitted program (its
    # lax.while_loop and the elementwise passes around it), one fused kernel
    # a slab; and the march alone of the occlusion masks.
    "visibility_batch": ("wass_tpu_torch/csrc/visibility.cu", "wass_tpu/post/geometry.py:94"),
    "visibility_march": ("wass_tpu_torch/csrc/visibility.cu", "wass_tpu/post/geometry.py:33"),
    # Not Pallas kernels: the flow solver's compiled loops (flow.py:
    # variational_refine), the outer warp and linearisation (outer_body) and
    # one Jacobi sweep of the inner lax.scan.
    "flow_linearize": ("wass_tpu_torch/csrc/flow.cu", "wass_tpu/stereo/flow.py:248"),
    "flow_jacobi": ("wass_tpu_torch/csrc/flow.cu", "wass_tpu/stereo/flow.py:261"),
    # Not a Pallas kernel: the host JPEG encode of the debug renders
    # (io/image.py:encode_jpeg), where the JAX package writes through imageio.
    "jpeg": ("wass_tpu_torch/csrc/jpeg.cu", "wass_tpu/utils/render.py:21"),
}
# The default path's SGM keys, which no H2 frame may launch.
DEFAULT_SGM = ("sgm_wta_fused", "sgm_wta_fused_windowed", "sgm_aggregate", "sgm_aggregate_windowed")
# Kernels each main-path run must launch (phase 4 per frame, phase 4b per run).
WINDOWED_PATH = ("census", "census_cost", "census_cost_windowed", "sgm_wta_fused", "sgm_wta_fused_windowed", "label_propagate")


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


def queued_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn() over reps back-to-back runs: the launches
    queue behind a 50 ms device sleep, so a kernel shorter than its host
    call is timed without the host's gaps."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms of clocks at 1.98 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def census_transform_bound(img, nw: int) -> tuple:
    """The census kernel's bound: the image read once, the nw words a pixel
    written once."""
    return bound(4 * img.numel() * (1 + nw), 0)


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
        for img, words in ((base, cb), (match, cm)):
            _record(results, "census", sk.census_transform(img, (7, 9), 0.8), words,
                    f"{tag} {tuple(img.shape)} sigma=0.8")
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
            cimg = [c2f.downsample_pool(x, 4) for x in (base, match)]
            ccb, ccm = (census_transform(x, (7, 9), 0.0) for x in cimg)
            for img, words in zip(cimg, (ccb, ccm)):
                _record(results, "census", sk.census_transform(img, (7, 9), 0.0), words,
                        f"coarse {tuple(img.shape)} sigma=0")
            # The census kernel at the main path's two shapes, against the
            # bytes it must move and the plain version's ~300 launches.
            for img, sigma, words in ((base, 0.8, cb), (cimg[0], 0.0, ccb)):
                k_ms = queued_ms(lambda: sk.census_transform(img, (7, 9), sigma))
                p_ms = cuda_ms(lambda: census_transform(img, (7, 9), sigma))
                b_ms, b_by = census_transform_bound(img, words.shape[2])
                if img is base:
                    results["census"].update(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
                log(f"time census {tuple(img.shape)} sigma={sigma}: kernel {k_ms:.4f} ms, bound {b_ms:.4f} ms "
                    f"({b_by}), {100 * b_ms / k_ms:.1f}% of it, plain {p_ms:.3f} ms")
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
        _record(results, "census", sk.census_transform(base, CENSUS_9X9, 0.8), cb9, f"{tag} {tuple(base.shape)} {what}")
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


def host_ms(fn, reps: int = 3) -> tuple:
    """(host ms a call, the last result) of fn over reps calls."""
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return (time.perf_counter() - t0) / reps * 1e3, out


def check_decode(img8, root: Path, card: str) -> None:
    """Phase I decode: the 2048x1536 frame as PNG with each of the five row
    filters and as cv2.imencode writes it (libpng's adaptive filters), each
    decoded bit-equal by the port's numpy codec and by the OpenCV path, with
    the ms an image of each; the port's filter-0 encode; then 8 decodes of
    a filter-0 and of a Paeth PNG one after another and on the 4-thread
    prefetcher."""
    import cv2
    import numpy as np

    from wass_tpu_torch.io import png
    from wass_tpu_torch.io.prefetch import Prefetcher
    from wass_tpu_torch.testing import png_with_filters

    enc_ms, _ = host_ms(lambda: png.encode_gray(img8))
    log(f"phase I encode: the port's filter-0 PNG writer {enc_ms:.1f} ms an image ({img8.shape[1]}x{img8.shape[0]})")
    forms = {f"filter {k}": png_with_filters(img8, k) for k in range(5)}
    forms["cv2.imencode (libpng's adaptive filters)"] = cv2.imencode(".png", img8)[1].tobytes()
    for name, data in forms.items():
        plain_ms, a = host_ms(lambda: png.decode_gray_plain(data), 1)
        cv_ms, b = host_ms(lambda: png.decode_gray(data))
        if not (np.array_equal(a, img8) and np.array_equal(b, img8)):
            raise AssertionError(f"phase I decode {name}: a decoder changed the image")
        log(f"phase I decode {name} ({len(data)} bytes): numpy codec {plain_ms:.1f} ms, OpenCV {cv_ms:.1f} ms an "
            "image, both bit-equal")
    for name, k in (("filter-0", 0), ("Paeth", 4)):
        paths = []
        for i in range(8):
            path = root / f"decode_{k}_{i}.png"
            path.write_bytes(forms[f"filter {k}"])
            paths.append(path)
        t0 = time.perf_counter()
        for path in paths:
            png.read_gray(path)
        serial = (time.perf_counter() - t0) / len(paths)
        with Prefetcher(4) as pf:
            t0 = time.perf_counter()
            for t in [pf.submit(path) for path in paths]:
                pf.take(t)
            pooled = (time.perf_counter() - t0) / len(paths)
        log(f"phase I decode: 8 {name} PNGs one after another {serial * 1e3:.1f} ms an image, on the 4-thread "
            f"prefetcher {pooled * 1e3:.1f} ms an image ({serial / pooled:.2f}x); on {card}")


RAW_FORMS = ("colour_png", "png16", "jpeg95", "tiff32")  # phase I's raw frame forms (testing.RAW_FORMATS)
# Phase I's render files: stereo renders a frame (phase 4), match renders a
# matched frame (phase M), each with its image shape for an (H, W) frame.
STEREO_RENDERS = {"stereo_input.jpg": lambda h, w: (2 * h, w, 3), "disparity_final_scaled.jpg": lambda h, w: (h, w),
                  "stereo.jpg": lambda h, w: (h, 2 * w, 3), "disparity_coverage.jpg": lambda h, w: (h, w, 3),
                  "graph_components.jpg": lambda h, w: (h, w), "triangulation_failmap.jpg": lambda h, w: (h, w, 3)}
MATCH_RENDERS = {"matches.jpg": lambda h, w: (h, 2 * w, 3), "matches_epifilter.jpg": lambda h, w: (h, 2 * w, 3)}


@contextlib.contextmanager
def frame0_renders():
    """Phase I: keeps frame 0's render images from the card and the tensors
    they were made from, fetched, while the stereo loop runs (the loop logs
    and swallows a render error, so the check comes after the run)."""
    from wass_tpu_torch.cli.pipeline import SequencePipeline

    original = SequencePipeline._write_renders
    kept: dict = {}

    def keep(wd, geom, res, extras):
        if wd.path.name == "000000_wd":
            from wass_tpu_torch.utils import render

            images = render.stereo_renders(res.disparity, res.valid, res.fail_reasons, extras["imgs"],
                                           extras["rect"], geom.roi)
            kept["card"] = {name: img.cpu() for name, img in images.items()}
            kept["inputs"] = (res.disparity.cpu(), res.valid.cpu(), res.fail_reasons.cpu(),
                              [t.cpu() for t in extras["imgs"]], [t.cpu() for t in extras["rect"]], geom.roi)
        return original(wd, geom, res, extras)

    SequencePipeline._write_renders = staticmethod(keep)
    try:
        yield kept
    finally:
        SequencePipeline._write_renders = staticmethod(original)


def check_render_files(wds, renders: dict, what: str) -> None:
    """Phase I: each render file of each workdir exists and decodes to its
    shape."""
    import cv2
    import numpy as np

    for wd in wds:
        h, w = cv2.imread(str(wd / "undistorted" / "00000000.png"), cv2.IMREAD_UNCHANGED).shape
        for name, shape in renders.items():
            path = wd / name
            img = cv2.imdecode(np.fromfile(path, np.uint8), cv2.IMREAD_UNCHANGED) if path.exists() else None
            if img is None or img.shape != shape(h, w):
                raise AssertionError(f"phase I {what}: {wd.name}/{name} missing or of shape "
                                     f"{None if img is None else img.shape}, expected {shape(h, w)}")
    log(f"phase I {what}: {len(renders)} renders in each of {len(wds)} workdirs, each decoding to its shape")


def check_jpeg(results: dict, img_pair, dev, card: str) -> None:
    """Phase 3, the JPEG kernel: one 5 MP frame's six debug renders
    (utils/render.py:stereo_renders at 2560x1920, from the slice pair
    scaled up and a disparity ramp with an invalid band) encoded in one
    call; each file must equal OpenCV's encoding of the image and the plain
    version's.  The call's device time (CUDA events, its launches queued
    behind a device sleep) beside its bound: the images' bytes read and the
    streams' written at the memory rate, or the DCTs' integer operations
    (JPEG_DCT_OPS a block) at the ALU rate, whichever is larger; and
    OpenCV's and the plain version's host times for the same six images."""
    import torch
    import torch.nn.functional as F

    from wass_tpu_torch.io import jpeg
    from wass_tpu_torch.io.image import RENDER_QUALITY, encode_jpeg
    from wass_tpu_torch.stereo.dense import FAIL_NO_DISPARITY
    from wass_tpu_torch.utils import render

    h, w = JPEG_FRAME
    rect = [F.interpolate(torch.as_tensor(x, dtype=torch.float32)[None, None].to(dev), size=(h, w), mode="bilinear",
                          align_corners=False)[0, 0] for x in img_pair]
    imgs = tuple(torch.clamp(x, 0, 255).to(torch.uint8) for x in rect)
    disp = (100.0 + torch.arange(w, dtype=torch.float32, device=dev) / 40.0).expand(h, w).clone()
    disp[:, :w // 10] = float("nan")
    valid = torch.isfinite(disp)
    fails = torch.where(valid, 0, FAIL_NO_DISPARITY).to(torch.uint8)
    images = render.stereo_renders(disp, valid, fails, imgs, rect, (w // 10, 0, w - w // 10, h))
    tensors = list(images.values())
    host = [t.cpu().numpy() for t in tensors]
    cv_ms, want = host_ms(lambda: [encode_jpeg(x, RENDER_QUALITY) for x in host], 1)
    plain_ms, plain = host_ms(lambda: [jpeg.encode_plain(x, RENDER_QUALITY) for x in host], 1)
    enc = jpeg.device_encoder({}, tensors, RENDER_QUALITY)
    got = enc.fetch(enc.run(tensors))
    differ = [name for name, a, b, c in zip(images, got, want, plain) if not a == b == c]
    if differ:
        raise AssertionError(f"phase 3: the JPEG kernel's files differ from OpenCV's or the plain version's: {differ}")
    k_ms = queued_ms(lambda: enc.launch(tensors))
    blocks = jpeg.layout(enc.shapes)[1]
    stream_bytes = sum(len(f) - len(hdr) - 2 for f, hdr in zip(got, enc.headers))
    b_ms, b_by = bound(sum(t.numel() for t in tensors) + stream_bytes, JPEG_DCT_OPS * blocks)
    results["jpeg"].update(ms=k_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    log(f"kernel jpeg {len(tensors)} renders of a {h}x{w} frame ({', '.join(str(tuple(t.shape)) for t in tensors)}; "
        f"{blocks} blocks, {stream_bytes} stream bytes): byte-equal to OpenCV and the plain version")
    log(f"time jpeg {h}x{w} frame: kernel {k_ms:.4f} ms ({jpeg.KERNELS_A_CALL} launches), bound {b_ms:.4f} ms "
        f"({b_by}), {100 * b_ms / k_ms:.1f}% of it; OpenCV {cv_ms:.1f} ms, plain {plain_ms:.1f} ms on the host; {card}")


def check_frame0_renders(kept: dict, wd: Path, card: str) -> None:
    """Phase I: frame 0's render images on the card bit-equal to the same
    functions on the CPU over the same fetched tensors; the files the loop
    wrote against the card's images encoded again (printed); then where a
    writer's render time goes: the images built on the card (CUDA events),
    fetched, and each JPEG encode on the host."""
    import torch

    from wass_tpu_torch.io.image import encode_jpeg
    from wass_tpu_torch.utils import render

    if "card" not in kept:
        raise AssertionError("phase I: frame 0's renders were not made")
    t0 = time.perf_counter()
    cpu = render.stereo_renders(*kept["inputs"])
    cpu_s = time.perf_counter() - t0
    differ = [name for name, img in kept["card"].items() if not torch.equal(img, cpu[name])]
    if differ or sorted(cpu) != sorted(STEREO_RENDERS):
        raise AssertionError(f"phase I: frame 0's renders differ between the card and the CPU: {differ}")
    other_file = [name for name, img in kept["card"].items()
                  if (wd / name).read_bytes() != encode_jpeg(img.numpy())]
    if other_file:
        raise AssertionError(f"phase I: frame 0's JPEG files differ from OpenCV's encoding of its images: {other_file}")
    log(f"phase I renders: frame 0's {len(cpu)} images bit-equal card / CPU ({cpu_s:.2f} s on the CPU; "
        f"{', '.join(f'{n} {tuple(i.shape)}' for n, i in kept['card'].items())}); the loop's {len(cpu)} files "
        "(encoded on the card) equal to OpenCV's encoding of the card's images")
    disparity, valid, fails, imgs, rect, roi = kept["inputs"]
    dev = torch.device("cuda")
    inputs = (disparity.to(dev), valid.to(dev), fails.to(dev), [t.to(dev) for t in imgs], [t.to(dev) for t in rect],
              roi)
    build_ms = cuda_ms(lambda: render.stereo_renders(*inputs), reps=3)
    images = render.stereo_renders(*inputs)
    torch.cuda.synchronize()
    fetch_ms, fetched = host_ms(lambda: {name: img.cpu().numpy() for name, img in images.items()})
    encode = {name: host_ms(lambda: encode_jpeg(img), 1)[0] for name, img in fetched.items()}
    log(f"phase I render time of frame 0: built on the card {build_ms:.1f} ms (CUDA events), fetched {fetch_ms:.1f} "
        f"ms, JPEG encodes {sum(encode.values()):.1f} ms on the host ({', '.join(f'{n} {v:.1f}' for n, v in encode.items())}); "
        f"on {card}")


def check_raw_forms(root: Path, rig, scene) -> dict:
    """Phase I prepare: phase P's raw pairs again as colour PNG (R = G = B),
    16-bit PNG (x 257), quality-95 JPEG and float32 TIFF through `prepare`
    and `stereo` on the card.  The lossless forms must give phase P's
    undistorted PNGs, mesh_cam.xyzC and plane.txt byte for byte; the JPEG
    frames' elevation error is printed beside the 0.02 gate.  Returns the
    stereo runs' launches."""
    import numpy as np

    import wass_tpu_torch
    from wass_tpu_torch.cli.main import main as cli_main
    from wass_tpu_torch.testing import load_or_render_raw, read_frame, trimmed_elevation_error, write_raw_sequence

    raw = load_or_render_raw(rig, SCENE_SEED, *PREP_DIST, root)
    ref = root / "smoke_prepared"
    files = ("undistorted/00000000.png", "undistorted/00000001.png", "mesh_cam.xyzC", "plane.txt")
    launches: dict = {}
    for fmt in RAW_FORMS:
        cam0, cam1, calib = write_raw_sequence(root / f"smoke_raw_{fmt}", *raw, rig, PREP_FRAMES, *PREP_DIST, fmt=fmt)
        out = root / f"smoke_prepared_{fmt}"
        shutil.rmtree(out, ignore_errors=True)
        t0 = time.time()
        if cli_main(["prepare", str(cam0), str(cam1), str(calib), str(out)]) != 0:
            raise AssertionError(f"phase I: prepare failed on the {fmt} frames")
        t_prep = time.time() - t0
        shutil.copy(ref / "stereo_config.txt", out / "stereo_config.txt")
        wass_tpu_torch.reset_launch_counts()
        if cli_main(["stereo", str(out)]) != 0:
            raise AssertionError(f"phase I: stereo failed on the {fmt} frames")
        add_counts(launches, wass_tpu_torch.launch_counts())
        wds = sorted(out.glob("*_wd"))
        if len(wds) != PREP_FRAMES:
            raise AssertionError(f"phase I {fmt}: {len(wds)} workdirs")
        if fmt != "jpeg95":
            differ = [f"{wd.name}/{f}" for wd in wds for f in files
                      if (wd / f).read_bytes() != (ref / wd.name / f).read_bytes()]
            if differ:
                raise AssertionError(f"phase I {fmt}: files differ from phase P's: {differ}")
            log(f"phase I prepare {fmt}: {PREP_FRAMES} frames prepared in {t_prep:.2f} s; undistorted PNGs, "
                "mesh_cam.xyzC and plane.txt byte-equal to phase P's")
            continue
        for i, wd in enumerate(wds):
            plane, mesh, _ = read_frame(wd)
            err = trimmed_elevation_error(scene, mesh, plane)
            log(f"phase I prepare {fmt} frame {i}: {len(mesh)} points, trimmed-mean elevation error {err:.5f} "
                f"({'under' if err < ELEVATION_GATE else 'over'} the {ELEVATION_GATE} gate; printed, not gated), "
                f"{c2f_line(wd) or 'no c2f'}; prepared in {t_prep:.2f} s")
    return launches


def check_stokes(root: Path, rig, dev) -> None:
    """Phase I Stokes: phase 5's frames through the demosaic prepare with
    save_stokes; frame 0's TIFFs read back bit-equal to the card's Stokes
    images; then `polarimetric_setup` over phase G's cube and the finite
    share of its averages (printed: no physics gate, the frames are not
    polarimetric)."""
    import numpy as np
    import torch

    from wass_tpu_torch.cli.pipeline import SequenceConfig, SequencePipeline
    from wass_tpu_torch.cli.post import main as post_main
    from wass_tpu_torch.io.image import read_float_tiff
    from wass_tpu_torch.io.workdir import frame_workdirs
    from wass_tpu_torch.prepare.polar import polarimetric_process
    from wass_tpu_torch.prepare.prepare import PrepareConfig

    wds = frame_workdirs(root / "smoke_loop")
    out = root / "smoke_stokes"
    shutil.rmtree(out, ignore_errors=True)
    pipe = SequencePipeline(out, SequenceConfig(prepare=PrepareConfig(demosaic=True, save_stokes=True)))
    t0 = time.time()
    pipe.prepare(((wd.load_undistorted(0), wd.load_undistorted(1)) for wd in wds), rig.K0, np.zeros(5), rig.K1,
                 np.zeros(5), rig.R, rig.T)
    t_prep = time.time() - t0
    x = torch.as_tensor(wds[0].load_undistorted(0), device=dev)
    res = polarimetric_process(x, torch.as_tensor(np.asarray(rig.K0, np.float32), device=dev),
                               torch.zeros(5, device=dev))
    for name in ("S0", "S1", "S2"):
        back = read_float_tiff(out / "000000_wd" / "undistorted" / f"00000000_{name}.tiff")
        if back.tobytes() != getattr(res, name).cpu().numpy().tobytes():
            raise AssertionError(f"phase I: {name}.tiff does not read back as the card's {name}")
    log(f"phase I Stokes: {len(wds)} frames through the demosaic prepare with save_stokes in {t_prep:.2f} s "
        f"(6 float32 TIFFs a frame, {(out / '000000_wd' / 'undistorted' / '00000000_S0.tiff').stat().st_size} bytes "
        "each); frame 0's S0, S1, S2 read back bit-equal")
    t0 = time.time()
    if post_main(["polarimetric_setup", str(root / "smoke_grid" / "gridded.nc"), "--wassdir", str(out),
                  "--outputdir", str(out / "pdata")]) != 0:
        raise AssertionError("phase I: polarimetric_setup failed")
    with np.load(out / "pdata" / "pdata_avg.npz") as z:
        shares = {k: float(np.isfinite(z[k]).mean()) for k in z.files}
    log(f"phase I polarimetric_setup over phase G's cube and the {len(wds)} frames: {time.time() - t0:.2f} s; "
        f"finite share {', '.join(f'{k} {v:.4f}' for k, v in shares.items())} (no physics gate)")


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


def profile_c2f_frame(root: Path, img0, img1, rig) -> dict:
    """Phase 5: the c2f frame's device stages and the sequence loop's rate.
    Returns the loop's frames/s by (dispatch_depth, writer_threads,
    renders)."""
    import numpy as np
    import torch

    from wass_tpu_torch.cli.main import load_pipeline
    from wass_tpu_torch.ops import components_kernels as ck
    from wass_tpu_torch.stereo import dense
    from wass_tpu_torch.stereo.c2f import coarse_disparity, compute_row_windows, windowed_disparity
    from wass_tpu_torch.stereo.sgm_kernels import census_transform
    from wass_tpu_torch.testing import write_sequence

    seq = root / "smoke_loop"
    write_sequence(seq, img0, img1, rig, LOOP_FRAMES)
    loop_rates = {}
    for (depth, writers), renders in [(s, r) for s in LOOP_SETTINGS for r in (True, False)]:
        pipe = load_pipeline(seq)
        pipe.cfg.dispatch_depth, pipe.cfg.writer_threads, pipe.cfg.debug_renders = depth, writers, renders
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rates, decode, dispatch, render_s = [], [], [], []
        for _ in range(3):
            t0 = time.time()
            pipe.stereo(progress_stream=io.StringIO())  # returns after the last frame's files are written
            rates.append(LOOP_FRAMES / (time.time() - t0))
            loop_rates[(depth, writers, renders)] = rates
            decode += pipe.loop_stats["decode_s"]
            dispatch += pipe.loop_stats["dispatch_s"]
            render_s += pipe.loop_stats["render_s"]
        rendering = (f"the six debug renders on the writer threads {1e3 * np.mean(render_s):.1f} ms a frame (max "
                     f"{1e3 * max(render_s):.1f})" if renders else "debug renders off")
        log(f"sequence loop (dispatch_depth {depth}, writer_threads {writers}, debug renders {'on' if renders else 'off'}"
            f"): {LOOP_FRAMES} frames a pass, frames/s {' '.join(f'{r:.4f}' for r in rates)} (PNG decode to .xyzC "
            f"written; the first pass includes the warm-up); PNG decode on the prefetch threads "
            f"{1e3 * np.mean(decode):.1f} ms an image (max {1e3 * max(decode):.1f}); dispatch on the main thread "
            f"{1e3 * np.mean(dispatch):.1f} ms a frame (max {1e3 * max(dispatch):.1f}); {rendering}; peak device "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

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
    return loop_rates

FLOW_FRAMES = 3  # phase F's frames: phase 5's scene with ENABLE_OPTICAL_FLOW=true
FLOW_CONFIG = "ENABLE_OPTICAL_FLOW=true\n"  # phase F's stereo_config.txt (the defaults otherwise)
FLOW_GATE = 0.05  # tests/test_flow.py's gate on the flow points' trimmed-mean elevation error (stereo: 0.02)
FLOW_MAX_MOTION = 200.0  # the flow renders' max motion (the stereo loop's)
# Bytes each flow kernel must move a pixel (inputs read once, outputs written
# once) and its float operations a pixel: the linearisation reads u, v, I0
# and the three sampled fields and writes It, Ix, Iy, wdata (u, v stay the
# sweeps' warp point); a sweep reads u, v, u0, v0, It, Ix, Iy, wdata and
# writes u', v'.
FLOW_BYTES = {"flow_linearize": 4 * (6 + 4), "flow_jacobi": 4 * (8 + 2)}
FLOW_OPS = {"flow_linearize": 40, "flow_jacobi": 46}


def read_ply_points(path: Path) -> tuple:
    """(header vertex count, (N, 3) float32 points, (N, 3) uint8 colours) of
    a binary xyz+rgb PLY (io/ply.py:save_ply_points)."""
    import numpy as np

    data = path.read_bytes()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    n = int(data[:end].decode().split("element vertex ")[1].split("\n")[0])
    if len(data) - end != 15 * n:
        raise AssertionError(f"{path.name}: {len(data) - end} bytes of vertices for {n} vertices")
    rec = np.frombuffer(data[end:], dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
    return n, rec["xyz"], rec["rgb"]


def flow_stages(disp, valid_rect, b8, m8, geom, cfg, min_disp: float, out: Path) -> tuple:
    """Phase F: one frame's flow stage by stage (CUDA events; a synchronize
    between stages; the solver's launches timed one by one) and the host
    render and PLY write (into out).  Returns (times, FlowResult, the first
    linearisation's inputs, the second sweep's inputs)."""
    import numpy as np
    import torch

    from wass_tpu_torch.io.ply import save_ply_points
    from wass_tpu_torch.stereo import flow as fl
    from wass_tpu_torch.stereo import flow_kernels as fk
    from wass_tpu_torch.utils import render

    times: dict = {}

    def stage(name, fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times[name] = start.elapsed_time(end)
        return out

    I0, I1 = b8.to(torch.float32), m8.to(torch.float32)
    H, W = I0.shape
    flow, valid = stage("coarse flow", lambda: fl.coarse_flow_from_disparity(disp, geom.H_base, geom.Hi_match, (H, W),
                                                                             min_disp, valid_rect))
    mask = stage("opening", lambda: fl.binary_erode(fl.binary_dilate(valid.float(), cfg.opening_dilate),
                                                    cfg.opening_erode))
    coarse = stage(f"IDW fill ({cfg.idw_reps} passes, plain torch)", lambda: fl.idw_fill(flow, valid, cfg.idw_reps))
    outer = max(1, cfg.fullres_iterations // cfg.inner_iterations)
    lam = fl.smoothness_ratio(cfg.fullres_smoothness, cfg.color_consistency)
    u, v = coarse[..., 0].contiguous(), coarse[..., 1].contiguous()
    g1x, g1y = stage("image gradients", lambda: fl._image_grads(I1))
    lin_in, jac_in = (I0, I1, g1x, g1y, u, v), None
    # The solver's buffers rotate as in variational_refine, from copies, so
    # that lin_in keeps the first warp point.
    u, v = u.clone(), v.clone()
    spare = [(torch.empty_like(u), torch.empty_like(v)) for _ in range(2)]
    events = {"flow_linearize": [], "flow_jacobi": []}
    torch.cuda.synchronize()
    for _ in range(outer):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        u0, v0 = u, v
        ev[0].record()
        It, Ix, Iy, wdata = fk.flow_linearize(I0, I1, g1x, g1y, u0, v0)
        ev[1].record()
        events["flow_linearize"].append(ev)
        for k in range(cfg.inner_iterations):
            if jac_in is None and k == 1:  # copies: the rotation overwrites u and the warp point later
                jac_in = (u.clone(), v.clone(), *lin_in[4:], It, Ix, Iy, wdata, lam)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            u, v = fk.flow_jacobi(u, v, u0, v0, It, Ix, Iy, wdata, lam, out=spare[k % 2])
            ev[1].record()
            events["flow_jacobi"].append(ev)
        spare[(cfg.inner_iterations - 1) % 2] = (u0, v0)
    torch.cuda.synchronize()
    for name, evs in events.items():
        times[f"{len(evs)} x {name}"] = sum(a.elapsed_time(b) for a, b in evs)
    refined = torch.stack([u, v], -1)

    def gates():
        ok = fl.flow_correspondence_gates(refined, mask, I0, I1) & (fl.norm2(refined - coarse) <= 4.0)
        return fl.triangulate_flow(refined, ok, geom.K0, geom.K1, geom.R, geom.T, bool(geom.base_is_cam0), cfg)

    pts, ok = stage("gates + triangulation", gates)
    fr = fl.FlowResult(flow=refined, coarse_flow=coarse, points=pts, valid=ok)
    out.mkdir(parents=True, exist_ok=True)
    images = []
    t0 = time.perf_counter()
    for f in (coarse, refined):
        images.append(render.render_flow(f, FLOW_MAX_MOTION))
    t1 = time.perf_counter()
    for name, img in zip(("flow_coarse.png", "flow.png"), images):
        render.save_png(out / name, img)
    times["render (host: fetch, float64 numpy), 2 images"] = 1e3 * (t1 - t0)
    times["PNG encode + write (host, zlib), 2 images"] = 1e3 * (time.perf_counter() - t1)
    t0 = time.perf_counter()
    save_ply_points(out / "mesh_full_flow.ply", pts[ok].cpu().numpy(),
                    np.repeat(b8[ok].cpu().numpy()[:, None], 3, axis=1))
    times["PLY write (host: fetch, write)"] = 1e3 * (time.perf_counter() - t0)
    return times, fr, lin_in, jac_in


def run_flow_phase(root: Path, img0, img1, rig, scene, results: dict, card: str, loop_rates: dict) -> dict:
    """Phase F: the optical flow through SequencePipeline on FLOW_FRAMES of
    phase 5's frames (ENABLE_OPTICAL_FLOW=true, the default loop settings,
    renders on).  Returns the main-path run's launches."""
    import numpy as np
    import torch

    import wass_tpu_torch
    from wass_tpu_torch.cli import pipeline as cli_pipeline
    from wass_tpu_torch.cli.main import load_pipeline
    from wass_tpu_torch.io.image import read_image
    from wass_tpu_torch.stereo import flow as fl
    from wass_tpu_torch.stereo import flow_kernels as fk
    from wass_tpu_torch.testing import read_frame, trimmed_elevation_error, write_sequence

    t_phase = time.time()
    seq = root / "smoke_flow"
    shutil.rmtree(seq, ignore_errors=True)
    write_sequence(seq, img0, img1, rig, FLOW_FRAMES)
    (seq / "stereo_config.txt").write_text(FLOW_CONFIG)
    pipe = load_pipeline(seq)
    if pipe.cfg.flow != fl.FlowConfig() or not pipe.cfg.debug_renders:
        raise AssertionError(f"phase F: flow config {pipe.cfg.flow}, renders {pipe.cfg.debug_renders}")
    kept: dict = {}
    write_flow = cli_pipeline.SequencePipeline._write_flow

    def keep_flow(self, wd, geom, res, extras):
        fr = write_flow(self, wd, geom, res, extras)
        kept[wd.path.name] = int(fr.valid.sum())
        if wd.path.name == "000000_wd" and "inputs" not in kept:
            kept["inputs"] = (res.disparity.clone(), res.valid.clone(), *(t.clone() for t in extras["imgs"]), geom,
                              fr)
        return fr

    cli_pipeline.SequencePipeline._write_flow = keep_flow
    try:
        wass_tpu_torch.reset_launch_counts()
        t0 = time.time()
        pipe.stereo(progress_stream=io.StringIO())
        wall = time.time() - t0
        launches = wass_tpu_torch.launch_counts()
        rates = []
        for _ in range(2):
            t0 = time.time()
            pipe.stereo(progress_stream=io.StringIO())
            rates.append(FLOW_FRAMES / (time.time() - t0))
    finally:
        cli_pipeline.SequencePipeline._write_flow = write_flow
    outer = max(1, pipe.cfg.flow.fullres_iterations // pipe.cfg.flow.inner_iterations)
    want = {"flow_linearize": outer, "flow_jacobi": outer * pipe.cfg.flow.inner_iterations}
    log(f"phase F: {FLOW_FRAMES} frames with the optical flow through SequencePipeline (dispatch_depth "
        f"{pipe.cfg.dispatch_depth}, writer_threads {pipe.cfg.writer_threads}, renders on) in {wall:.2f} s (first "
        f"pass); launches {launches}")
    for i in range(FLOW_FRAMES):
        wd = seq / f"{i:06d}_wd"
        ref = root / "smoke_loop" / wd.name
        differ = [n for n in ("mesh_cam.xyzC", "plane.txt") if (wd / n).read_bytes() != (ref / n).read_bytes()]
        if differ:
            raise AssertionError(f"phase F frame {i}: {differ} differ from phase 5's frame with the flow off")
        for name in ("flow_coarse.png", "flow.png"):
            shape = read_image(wd / name).shape
            if shape != (H, W, 3):
                raise AssertionError(f"phase F frame {i}: {name} decodes to {shape}")
        n, pts, cols = read_ply_points(wd / "mesh_full_flow.ply")
        if n != kept[wd.name] or not np.isfinite(pts).all():
            raise AssertionError(f"phase F frame {i}: PLY of {n} vertices, {kept[wd.name]} valid flow pixels")
        plane, _, per_frame = read_frame(wd)
        if any(per_frame.get(k) != c for k, c in want.items()):
            raise AssertionError(f"phase F frame {i}: flow launches {per_frame}, want {want}")
        err = trimmed_elevation_error(scene, pts, plane)
        log(f"phase F frame {i}: mesh_cam.xyzC and plane.txt byte-equal to the flow-off frame; flow_coarse.png, "
            f"flow.png {H}x{W}x3; mesh_full_flow.ply {n} points (= the valid count), trimmed-mean elevation error "
            f"{err:.5f} (gate {FLOW_GATE}); launches {per_frame}")
        if not err < FLOW_GATE:
            raise AssertionError(f"phase F frame {i}: flow elevation error {err} >= {FLOW_GATE}")
    off = loop_rates[(pipe.cfg.dispatch_depth, pipe.cfg.writer_threads, True)]
    log(f"phase F: frames/s with the flow {' '.join(f'{r:.4f}' for r in rates)} ({FLOW_FRAMES} frames a pass, "
        f"renders on) against phase 5's flow off {' '.join(f'{r:.4f}' for r in off)} ({LOOP_FRAMES} frames a pass)")

    # Frame 0's flow stage by stage, the kernels against their plain versions.
    disp, valid_rect, b8, m8, geom, fr_loop = kept["inputs"]
    times, fr, lin_in, jac_in = flow_stages(disp, valid_rect, b8, m8, geom, pipe.cfg.flow,
                                            float(pipe.cfg.stereo.min_disp), root / "smoke_flow_stages")
    for name in ("flow", "coarse_flow", "points", "valid"):
        if not torch.equal(getattr(fr, name), getattr(fr_loop, name)):
            raise AssertionError(f"phase F: the staged flow's {name} differs from the loop's")
    for name, ms in times.items():
        log(f"phase F stage {name}: {ms:.3f} ms")
    log(f"phase F stage sum: {sum(times.values()):.3f} ms (frame 0, {int(fr.valid.sum())} points, the same bits as "
        f"the loop's frame); {card}")
    n = H * W
    checks = {"flow_linearize": (lambda: fk.flow_linearize(*lin_in), lambda: fk.flow_linearize_plain(*lin_in)),
              "flow_jacobi": (lambda: fk.flow_jacobi(*jac_in), lambda: fk.flow_jacobi_plain(*jac_in))}
    for name, (kernel, plain) in checks.items():
        for a, b in zip(kernel(), plain()):
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], compare(name, a, b))
        log(f"kernel {name} on frame 0's inputs ({W}x{H}): every output bit-equal")
        results[name]["ms"] = cuda_ms(kernel, 20)
        results[name]["plain_ms"] = cuda_ms(plain, 3)
        set_bound(results, name, FLOW_BYTES[name] * n, FLOW_OPS[name] * n)
        r = results[name]
        log(f"kernel {name}: {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}; {FLOW_BYTES[name]} bytes a pixel), {100 * r['bound_ms'] / r['ms']:.1f}% of it; "
            f"{want[name]} launches a flow frame")

    # The whole solver: the kernels against the plain versions' loop on the card.
    I0, I1, g1x, g1y, u, v = lin_in
    cfg = pipe.cfg.flow
    lam = fl.smoothness_ratio(cfg.fullres_smoothness, cfg.color_consistency)
    coarse = torch.stack([u, v], -1)

    def plain_solver():
        pu, pv = u, v
        for _ in range(outer):
            u0, v0 = pu, pv
            It, Ix, Iy, wdata = fk.flow_linearize_plain(I0, I1, g1x, g1y, u0, v0)
            for _ in range(cfg.inner_iterations):
                pu, pv = fk.flow_jacobi_plain(pu, pv, u0, v0, It, Ix, Iy, wdata, lam)
        return torch.stack([pu, pv], -1)

    def kernel_solver():
        return fl.variational_refine(I0, I1, coarse, cfg.fullres_smoothness, cfg.color_consistency, outer,
                                     cfg.inner_iterations)

    compare("flow solver (kernels against the plain loop)", kernel_solver(), plain_solver())
    if not torch.equal(kernel_solver(), fr.flow):
        raise AssertionError("phase F: the solver's result differs from the frame's refined flow")
    k_ms, p_ms = cuda_ms(kernel_solver, 3), cuda_ms(plain_solver, 1)
    log(f"phase F solver ({outer} linearisations, {outer * cfg.inner_iterations} sweeps, 2048x1536): kernels "
        f"{k_ms:.3f} ms, the plain versions on the card {p_ms:.3f} ms (a record, not a yardstick), bit-equal; "
        f"bounds {outer * results['flow_linearize']['bound_ms'] + want['flow_jacobi'] * results['flow_jacobi']['bound_ms']:.3f} ms; {card}")
    log(f"phase F: {time.time() - t_phase:.1f} s wall")
    return launches


PLOT_SHAPES = {"area_grid.png": (1200, 1200, 3), "gridded.png": (800, 800, 3), "spectrum.png": (720, 1200, 3)}


@contextlib.contextmanager
def plot_capture():
    """The three figure functions wrapped: plots[name] gets (the function,
    its arguments, its draw ms) for each call, keyed by the file it makes."""
    from wass_tpu_torch.cli import gridsurface
    from wass_tpu_torch.grid import gridding
    from wass_tpu_torch.post import plotting

    plots: dict = {}
    targets = [(gridsurface, "area_figure", "area_grid.png"), (gridding, "grid_figure", "gridded.png"),
               (plotting, "spectrum_figure", "spectrum.png")]
    saved = []
    for owner, attr, name in targets:
        fn = getattr(owner, attr)

        def drawn(*args, _fn=fn, _name=name, **kwargs):
            t0 = time.perf_counter()
            out = _fn(*args, **kwargs)
            plots.setdefault(_name, []).append((_fn, args, kwargs, 1e3 * (time.perf_counter() - t0)))
            return out

        setattr(owner, attr, drawn)
        saved.append((owner, attr, fn))
    try:
        yield plots
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def check_plots(plots: dict, files: dict, phase: str, card: str) -> None:
    """Each plot file decodes to its figure's shape and equals a re-render,
    on the host, from the arrays the console drew it from (fetched from the
    card); prints its draw and PNG ms."""
    import cv2

    for name, path in files.items():
        if not plots.get(name):
            raise AssertionError(f"phase {phase}: {path.name} was not drawn")
        fn, args, kwargs, draw_ms = plots[name][-1]
        img = cv2.imread(str(path), cv2.IMREAD_COLOR)
        if img is None or img.shape != PLOT_SHAPES[name]:
            raise AssertionError(f"phase {phase}: {path} decodes to {None if img is None else img.shape}")
        ax = fn(*args, **kwargs)
        if img[..., ::-1].tobytes() != ax.fig.image.tobytes():
            raise AssertionError(f"phase {phase}: {path.name} differs from its host re-render")
        t0 = time.perf_counter()
        ax.fig.save(path.with_suffix(".rerender.png"))
        save_ms = 1e3 * (time.perf_counter() - t0)
        path.with_suffix(".rerender.png").unlink()
        log(f"phase {phase} plot {path.name}: {img.shape[1]}x{img.shape[0]} RGB, equal to its host re-render from "
            f"the same arrays; drawn in {draw_ms:.1f} ms, PNG written in {save_ms:.1f} ms (host, {card})")


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
    from wass_tpu_torch.io.image import CAM_IMAGE_QUALITY, decode_gray, encode_jpeg
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
    with plot_capture() as plots:
        t_setup = grid_cli(seq, out, "--action", "setup", *area)
    check_plots(plots, {"area_grid.png": out / "area_grid.png"}, "G", card)
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
    with plot_capture() as plots:
        t_grid2 = grid_cli(seq, out, "--action", "grid")
    check_plots(plots, {"gridded.png": out / "gridded.png"}, "G", card)
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
        frame = png.read_gray(wds[0].undistorted_path(0))
        if image.tobytes() != encode_jpeg(frame, CAM_IMAGE_QUALITY):
            raise AssertionError("phase G: cam0images[0] is not the undistorted frame at JPEG quality 90")
        jpeg_err = int(np.abs(decode_gray(image.tobytes()).astype(np.int16) - frame).max())
    log(f"phase G: grid {n} frames (DCT, 500 iterations, nreps 10) {t_grid:.2f} s with the stage syncs, "
        f"{t_grid2:.2f} s without: {t_grid2 / n:.3f} s a frame; two runs byte-identical Z; the cube reads back "
        f"({cube_bytes} bytes, {len(image)} bytes of JPEG a frame, decoding within {jpeg_err} grey levels of the "
        f"frame); peak device memory {peak:.2f} GiB")
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
        if label == "--filter-outliers":  # the votes on the card: the same bytes on a second run
            grid_cli(one, mout, "--action", "grid", *grid_opts)
            with NetCDFReader(mout / "gridded.nc") as cube:
                if cube.Z[...].tobytes() != Z.tobytes():
                    raise AssertionError(f"phase G mode {label}: a second run gave other Z bytes")
            log(f"phase G mode {label}: a second run gives the same Z bytes")
    check_votes(wds[0], setup, card)
    check_refine(wds[0], setup, one, out, card)
    log(f"phase G: {time.time() - t_phase:.1f} s wall")


def check_refine(wd, setup, one: Path, out: Path, card: str) -> None:
    """Phase G --refine: frame 0's gridded Z (N = 256, DCT) refined by
    photo-consistency eagerly and by the CUDA graph of its Adam step (the
    first call captures it), then replayed again on the same inputs (the
    same bits required); then --refine through the console on one frame."""
    import numpy as np
    import torch

    from wass_tpu_torch.grid import gridding
    from wass_tpu_torch.grid import variational as gv
    from wass_tpu_torch.grid.netcdf import NetCDFReader

    cfg = gridding.GridConfig()
    Z, mask = gridding.grid_frame(wd, setup, cfg, device="cuda")
    inside = mask > 0
    P0, P1 = wd.load_projection_matrices()
    args = (Z, wd.load_undistorted(0), wd.load_undistorted(1), P0, P1, setup.Rpl, setup.Tpl, setup.XX, setup.YY,
            setup.baseline, inside.float())

    def run(**kw):
        stats: dict = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Zr = gv.variational_refine(*args, stats=stats, **kw)
        torch.cuda.synchronize()
        return Zr, 1e3 * (time.perf_counter() - t0), stats

    Ze, eager_ms, st_e = run(use_graph=False)
    Zg, first_ms, st_g = run()
    Zg2, replay_ms, _ = run()
    if not torch.equal(Zg.view(torch.int32), Zg2.view(torch.int32)):  # the bits, NaNs included
        raise AssertionError("phase G --refine: two graph replays on the same inputs gave other bits")
    if not (torch.equal(torch.isfinite(Zg), inside) and torch.equal(torch.isnan(Zg), ~inside)):
        raise AssertionError("phase G --refine: the refined Z is not finite inside the mask and NaN outside")
    dz = (Zg - Z).abs()[inside]
    H, W = Z.shape
    h, w = H // 2, W // 2
    # One step's least device time: Zc, mu and nu read and written, XX, YY
    # and the mask read, the four bilinear taps of each image; or the
    # derivative-of-Gaussian convolutions (2 x 49 multiply-adds a cell,
    # forward and backward) at 67 TFLOP/s.
    step_bound = bound(6 * 4 * h * w + 3 * 4 * H * W + 2 * 4 * 4 * H * W, 4 * 2 * 49 * 2 * H * W)
    n = inspect.signature(gv.variational_refine).parameters["max_iters"].default
    log(f"phase G --refine (frame 0, N = {H}, {n} Adam steps): eager {eager_ms:.1f} ms ({eager_ms / n:.3f} ms a "
        f"step), the CUDA graph's first call (capture + replays) {first_ms:.1f} ms, replays {replay_ms:.1f} ms "
        f"({1e3 * replay_ms / n:.1f} us a step; a step's bound {1e3 * step_bound[0]:.2f} us, {step_bound[1]}); "
        f"loss {st_g['loss_first']:.6g} at step 0 and {st_g['loss_last']:.6g} after step {n} (eager "
        f"{st_e['loss_first']:.6g}, {st_e['loss_last']:.6g}); mean |dZ| inside the mask {float(dz.mean()):.5f} m "
        f"(max {float(dz.max()):.4f}); eager against graph max |diff| {float((Ze - Zg).abs()[inside].max()):.3g} m; "
        f"two replays bit-equal; Z finite inside the mask, NaN outside; {card}")
    mout = one.parent / "smoke_grid_refine"
    shutil.rmtree(mout, ignore_errors=True)
    t = grid_cli(one, mout, "--action", "grid", "--gridsetup", str(out / "config.mat"), "--refine")
    with NetCDFReader(mout / "gridded.nc") as cube:
        Zc = cube.Z[0].T / 1000.0
    if not np.array_equal(np.isfinite(Zc), inside.cpu().numpy()):
        raise AssertionError("phase G --refine: the console's refined Z is not finite exactly inside the mask")
    log(f"phase G mode --refine: one frame {t:.2f} s through the console, "
        f"{100 * np.isfinite(Zc).mean():.1f}% finite, max |Z - the direct refinement| "
        f"{float(np.nanmax(np.abs(Zc - Zg.cpu().numpy()))):.3g} m")


def check_votes(wd, setup, card: str) -> None:
    """Phase G: the outlier votes (--filter-outliers) on frame 0's aligned
    points, twice on the card (timed) and once on the CPU."""
    import torch

    from wass_tpu_torch.grid import gridding, outliers

    thr = gridding.GridConfig().outlier_threshold
    pts = gridding.align_mesh(gridding.load_mesh(wd.path / "mesh_cam.xyzC", "cuda"), setup).T.float().contiguous()
    keep = [outliers._vote_device(pts, thr) for _ in range(2)]
    ms = cuda_ms(lambda: outliers._vote_device(pts, thr), reps=3)
    cpu = outliers._vote_device(pts.cpu(), thr)
    differ = (keep[0].cpu() != cpu).double().mean().item()
    if not torch.equal(keep[0], keep[1]):
        raise AssertionError("phase G votes: two runs on the card differ")
    log(f"phase G votes: frame 0's {pts.shape[0]} points, {100 * keep[0].double().mean().item():.4f}% kept; "
        f"{ms:.3f} ms a vote on the card; two card runs equal; {100 * differ:.4f}% of the votes differ between the "
        f"card and the CPU; on {card}")


POST_FRAMES = 3000  # phase S's cube: 200 s at 15 Hz (users film 10-30 min at 10-20 Hz; the cut is the duration)
POST_FPS = 15.0
POST_CHECK_FRAMES = 8  # the slab of the march's first kernel-vs-plain gate
HM0 = 1.0  # the wave field's significant height: 4 x std(eta), WaveField.random scales std(eta) to the amplitude 0.25
HM0_GATE = 0.10  # phase S's relative gate on spectrum's Hm0
MARCH_BYTES_PER_RAY = 4 + 12 + 1  # Z read, d read, the flag written
MARCH_OPS_PER_STEP = 13  # 3 adds, 2 roundings, 5 compares, the address, the compare with Z
VIS_BYTES_PER_CELL = 4 + 1 + 4  # Z read, occ and inc written
VIS_OPS_PER_CELL = 60  # the slopes, normal, ray, cosine, acosf (~15) and step of a cell, in float32 operations
POST_N512 = 512  # the finer grid of phase S's N = 512 slab
OCCLUSION_FRAMES = 4  # frames of phase S's compute_occlusion_mask run
SUN_ELEVATION_DEG = 1.0  # its rays' elevation: a low sun, whose rays the waves occlude


def wave_mm(setup, scene, XXm, YYm, t):
    """The scene's wave field in mm (float64, on t's device) at grid nodes
    of the setup's sea plane, XXm and YYm in meters (any one shape), and
    times t (s, a float64 tensor): (len(t), *XXm.shape).  The node on the
    sea plane -> cam0 -> world x, y."""
    import numpy as np
    import torch

    p = np.stack([XXm.ravel(), YYm.ravel(), np.zeros(XXm.size)]) / setup.baseline
    cam = setup.Rpl.T @ (p - setup.Tpl) * setup.baseline
    world = scene.rig.R0.T @ (cam - scene.rig.T0.reshape(3, 1))
    wx, wy = (torch.as_tensor(world[i], dtype=torch.float64, device=t.device) for i in (0, 1))
    t = t[:, None]
    eta = torch.zeros((t.shape[0], wx.shape[0]), dtype=torch.float64, device=t.device)
    waves = scene.waves
    for a, kx, ky, ph in zip(waves.amps, waves.kx, waves.ky, waves.phases):
        eta += a * torch.cos(kx * wx + ky * wy + ph - np.sqrt(9.81 * np.hypot(kx, ky)) * t)
    return (eta * 1000.0).reshape(-1, *XXm.shape)


def post_cube(path: Path, setup, scene, n_frames: int, fps: float, dev) -> None:
    """Phase S's cube: phase G's grid and meta, Z the scene's wave field
    (mm) at the grid nodes' world x, y (the node on the sea plane -> cam0 ->
    world) and t = i / fps, evaluated on the device in float64."""
    import numpy as np
    import torch

    from wass_tpu_torch.grid.netcdf import NetCDFWriter

    H, W = setup.XX.shape
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
            t = torch.arange(t0, min(t0 + 100, n_frames), dtype=torch.float64, device=dev) / fps
            for i, z in enumerate(wave_mm(setup, scene, setup.XX, setup.YY, t).cpu().numpy()):
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


def slab_tensors(z_mm, XXm, YYm, cam_m, dev) -> tuple:
    """A slab as visibilitymap hands it to the device: Z (mm) -> meters in
    float64 -> cell units in float32, the camera and the grids (meters) in
    cell units; (Z, cam, XX, YY, max_steps)."""
    import numpy as np
    import torch

    inv = 1.0 / (abs(XXm[0, 1] - XXm[0, 0]) or abs(XXm[1, 0] - XXm[0, 0]))

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(np.asarray(a, np.float64) * inv), dtype=torch.float32, device=dev)

    Z = put(np.asarray(z_mm, np.float64) / 1000.0)
    return Z, put(cam_m), put(XXm), put(YYm), 2 * max(Z.shape[1:])


def finer_grid(G, n: int):
    """The regular grid G (meters, either layout) resampled to n x n nodes
    over the same area."""
    import numpy as np

    s = (G.shape[0] - 1) / (n - 1)
    i, j = np.arange(n)[:, None] * s, np.arange(n)[None, :] * s
    return G[0, 0] + i * (G[1, 0] - G[0, 0]) + j * (G[0, 1] - G[0, 0])


def check_visibility(results: dict, Z_mm, grids: dict, cam_m, setup, scene, dev, card: str) -> None:
    """Phase S, gate 1: the fused visibility kernel and the march-only
    kernel against their plain versions on the card, bit-equal (occ equal,
    inc's bits equal, NaN at the same cells): an 8-frame slab of the cube
    (as the command lays it out, and with x along the columns), the camera
    0.5 m up (grazing rays that march to the grid's edge), the camera over
    the grid's middle, frame 0 with a NaN hole (its max NaN; the march-only
    kernel also with the nanmax, so that its rays march).  Then whole slabs,
    timed: the command's 341-frame slab, the same frames with x along the
    columns and the camera 0.5 m up, and an N = 512 slab both ways.  Each
    timed slab gives the fused kernel's time and its plain version's, its
    bound and share, the steps the rays took (counted by the plain march)
    and the steps a ns; the command's slab also the march-only kernel's."""
    import numpy as np
    import torch

    from wass_tpu_torch.post import visibility_kernels as vk
    from wass_tpu_torch.post.ooc import iter_time_slabs

    XX, YY = grids["XX"], grids["YY"]
    low = np.array([cam_m[0], cam_m[1], 0.5])  # a camera 0.5 m above the grid's plane
    mid = np.array([XX.mean(), YY.mean(), 5.0])  # a camera 5 m above the grid's middle

    def same_batch(what, Z, cam, XXt, YYt, steps):
        occ, inc = vk.visibility_batch(Z, cam, XXt, YYt, steps)
        occ_p, inc_p = vk.visibility_batch_plain(Z, cam, XXt, YYt, steps)
        torch.cuda.synchronize()
        nan, nan_p = torch.isnan(inc), torch.isnan(inc_p)
        if not (torch.equal(occ, occ_p) and torch.equal(nan, nan_p)
                and torch.equal(inc[~nan].view(torch.int32), inc_p[~nan].view(torch.int32))):
            raise AssertionError(f"visibility_batch {what}: kernel differs from the plain version (occ "
                                 f"{int((occ != occ_p).sum())} cells, inc {int((inc != inc_p).sum())} cells)")
        payload = int((inc[nan].view(torch.int32) != inc_p[nan].view(torch.int32)).sum())
        log(f"kernel visibility_batch {what} {tuple(Z.shape)}: bit-equal ({int(nan.sum())} NaN incidences, "
            f"{payload} of them with other NaN bits; {100 * occ.float().mean().item():.2f}% occluded)")
        return occ, inc

    def same_march(what, Z, d, maxz, steps):
        occ = vk.march(Z, d, maxz, steps)
        _record(results, "visibility_march", occ, vk.march_plain(Z, d, maxz, steps), what)
        return occ

    def case(what, z_mm, XXm=XX, YYm=YY, cam=cam_m):
        Z, camt, XXt, YYt, steps = slab_tensors(z_mm, XXm, YYm, cam, dev)
        occ, inc = same_batch(what, Z, camt, XXt, YYt, steps)
        d = vk.ray_steps(vk.view_rays(Z, camt, XXt, YYt))
        same_march(what, Z, d, Z.amax(dim=(1, 2)), steps)
        return Z, d, steps, occ, inc

    zs = Z_mm[:POST_CHECK_FRAMES]
    zt = np.ascontiguousarray(zs.transpose(0, 2, 1))  # x along the columns
    case(f"{POST_CHECK_FRAMES}-frame slab", zs)
    case(f"{POST_CHECK_FRAMES}-frame slab, x along the columns", zt, XX.T, YY.T)
    case(f"{POST_CHECK_FRAMES}-frame slab, x along the columns, the camera 0.5 m up", zt, XX.T, YY.T, low)
    case(f"{POST_CHECK_FRAMES}-frame slab, x along the columns, the camera over the grid's middle", zt, XX.T, YY.T,
         mid)
    hole = np.array(zt[:2], np.float32)
    H, W = hole.shape[1:]
    hole[0, H // 3:H // 3 + 9, W // 2:W // 2 + 13] = np.nan
    Z, d, steps, occ, inc = case("2 frames, frame 0 with a NaN hole (its max NaN), the camera 0.5 m up", hole,
                                 XX.T, YY.T, low)
    if not torch.equal(occ[0], inc[0] >= 88):
        raise AssertionError("phase S: a frame whose max is NaN occluded a cell that is not grazing")
    nanmax = torch.where(torch.isnan(Z), torch.full_like(Z, -1e30), Z).amax(dim=(1, 2))
    occ = same_march("2 frames, frame 0 with a NaN hole (its nanmax)", Z, d, nanmax, steps)
    if occ[torch.isnan(Z)].any() or not occ[0].any():
        raise AssertionError("phase S march: a ray from a NaN cell occluded its cell, or no ray of frame 0 did")

    def timed_slab(what, z_mm, XXm, YYm, cam, march_row=False) -> None:
        Z, camt, XXt, YYt, steps = slab_tensors(z_mm, XXm, YYm, cam, dev)
        same_batch(what, Z, camt, XXt, YYt, steps)
        d, maxz = vk.ray_steps(vk.view_rays(Z, camt, XXt, YYt)), Z.amax(dim=(1, 2))
        occ, n_steps = vk.march_plain(Z, d, maxz, steps, count_steps=True)
        _record(results, "visibility_march", vk.march(Z, d, maxz, steps), occ, what)
        ms = cuda_ms(lambda: vk.visibility_batch(Z, camt, XXt, YYt, steps), reps=5)
        plain_ms = cuda_ms(lambda: vk.visibility_batch_plain(Z, camt, XXt, YYt, steps))
        cells = Z.numel()
        nbytes = VIS_BYTES_PER_CELL * cells + 8 * Z.shape[1] * Z.shape[2] + 12
        b_ms, b_by = bound(nbytes, VIS_OPS_PER_CELL * cells + MARCH_OPS_PER_STEP * n_steps)
        log(f"phase S visibility_batch, {what} {tuple(Z.shape)}: fused kernel {ms:.4f} ms, plain {plain_ms:.1f} ms; "
            f"bound {b_ms:.4f} ms ({b_by}; {VIS_BYTES_PER_CELL} bytes a cell and XX, YY at 3.35 TB/s), "
            f"{100 * b_ms / ms:.1f}% of it; the rays took {n_steps} steps ({n_steps / cells:.2f} a ray, {steps} at "
            f"most), {n_steps / (ms * 1e6):.2f} steps a ns; {100 * occ.float().mean().item():.2f}% occluded by the "
            f"march; on {card}")
        m_ms = cuda_ms(lambda: vk.march(Z, d, maxz, steps), reps=5)
        m_bound = bound(MARCH_BYTES_PER_RAY * cells, MARCH_OPS_PER_STEP * n_steps)
        log(f"phase S march-only kernel on the same slab: {m_ms:.4f} ms, bound {m_bound[0]:.4f} ms "
            f"({MARCH_BYTES_PER_RAY} bytes a ray), {n_steps / (m_ms * 1e6):.2f} steps a ns; on {card}")
        if march_row:
            results["visibility_batch"].update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
            results["visibility_march"].update(ms=m_ms, plain_ms=cuda_ms(lambda: vk.march_plain(Z, d, maxz, steps)),
                                               bound_ms=m_bound[0], bound_by=m_bound[1])

    # Whole slabs (the command's: the budget's 8 bytes a cell), timed.
    ts = next(iter(iter_time_slabs(Z_mm.shape, 8)))
    timed_slab("the command's slab", Z_mm[ts], XX, YY, cam_m, march_row=True)
    timed_slab("the full slab with x along the columns, the camera 0.5 m up",
               np.ascontiguousarray(Z_mm[ts].transpose(0, 2, 1)), XX.T, YY.T, low)
    # An N = 512 slab over the same area: the command's slab of that size.
    X5, Y5 = finer_grid(XX, POST_N512), finer_grid(YY, POST_N512)
    t5 = next(iter(iter_time_slabs((Z_mm.shape[0], POST_N512, POST_N512), 8)))
    t = torch.arange(t5.start, t5.stop, dtype=torch.float64, device=dev) / POST_FPS
    z5 = wave_mm(setup, scene, X5, Y5, t).float().cpu().numpy()
    timed_slab(f"an N = {POST_N512} slab", z5, X5, Y5, cam_m)
    timed_slab(f"an N = {POST_N512} slab with x along the columns, the camera 0.5 m up",
               np.ascontiguousarray(z5.transpose(0, 2, 1)), X5.T, Y5.T, low)


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
    from wass_tpu_torch.post import visibility_kernels as vk
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

    # Gate 1: the visibility kernels against their plain versions (no main-path counts).
    check_visibility(results, Z_mm, stored, C[:3] / C[3], setup, scene, dev, card)
    del Z_mm

    fft = torch.fft
    s = str(nc)
    res, secs, times, peak, grown = post_cli(["info", s], dev=dev)
    log_post("info", secs, times, peak, grown, f" ({len(res.splitlines())} lines)")
    with plot_capture() as plots:
        res, secs, times, peak, grown = post_cli(["spectrum", s, "--nperseg", "512", "--rangespan", "5"],
                                                 [(fft, "rfft", "device rfft")], dev)
    check_plots(plots, {"spectrum.png": nc.with_suffix(".spectrum.png")}, "S", card)
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
    label = "device visibility batch (the fused kernel)"
    res, secs, times, peak, grown = post_cli(["visibilitymap", s], [(geometry, "visibility_device_batch", label)], dev)
    launches = wass_tpu_torch.launch_counts()
    batch_ms = np.array(times[label])
    log_post("visibilitymap", secs, times, peak, grown,
             f": {launches['visibility_batch']} launches of the fused kernel ({launches['visibility_march']} of the "
             f"march-only one), {batch_ms.mean():.3f} ms a slab (min {batch_ms.min():.3f}, max {batch_ms.max():.3f}); "
             f"{res.strip()}")
    if sha("Z_filtered") != before:
        raise AssertionError("phase S: visibilitymap changed Z_filtered")
    # The same command with the plain version on the card: the same bytes.
    outputs = ("occlusion_cam0", "incident_angles_cam0")
    fused = [sha(name) for name in outputs]
    saved = geometry.visibility_device_batch
    geometry.visibility_device_batch = vk.visibility_batch_plain
    try:
        label = "device visibility batch (the plain version)"
        res, secs, times, peak, grown = post_cli(["visibilitymap", s], [(geometry, "visibility_device_batch", label)],
                                                 dev)
    finally:
        geometry.visibility_device_batch = saved
    log_post("visibilitymap with the plain version", secs, times, peak, grown,
             f": {np.mean(times[label]):.3f} ms a slab")
    if [sha(name) for name in outputs] != fused:
        raise AssertionError("phase S: visibilitymap's outputs differ between the fused kernel and the plain version")
    log(f"phase S visibilitymap: {' and '.join(outputs)} byte-equal over the cube, the fused kernel's and the plain "
        f"version's (sha256 {fused[0][:16]}, {fused[1][:16]})")

    # The march-only entry's user: occlusion masks along a low sun's rays
    # (compute_occlusion_mask, cell units) on a few frames, card and CPU.
    dxm = abs(stored["XX"][0, 1] - stored["XX"][0, 0]) or abs(stored["XX"][1, 0] - stored["XX"][0, 0])
    with hdf5.H5File(nc) as f:
        zz = f["Z_filtered"][:OCCLUSION_FRAMES] / 1000.0 / dxm
    el = np.radians(SUN_ELEVATION_DEG)
    ray_d = np.broadcast_to(np.array([np.cos(el), 0.3 * np.cos(el), np.sin(el)]), zz.shape[1:] + (3,))
    wass_tpu_torch.reset_launch_counts()
    t0 = time.time()
    masks = [geometry.compute_occlusion_mask(z, ray_d, device=dev) for z in zz]
    secs = time.time() - t0
    launches["visibility_march"] = wass_tpu_torch.launch_counts()["visibility_march"]
    for z, m in zip(zz, masks):
        if not np.array_equal(m, geometry.compute_occlusion_mask(z, ray_d, device="cpu")):
            raise AssertionError("phase S: compute_occlusion_mask differs between the card and the CPU")
    share = float(np.mean(masks))
    if not 0 < share < 1:
        raise AssertionError(f"phase S: compute_occlusion_mask occluded {share} of the cells")
    log(f"phase S compute_occlusion_mask: {OCCLUSION_FRAMES} frames along a sun {SUN_ELEVATION_DEG} degrees up, "
        f"{secs:.3f} s, {launches['visibility_march']} launches of the march-only kernel, {100 * share:.2f}% "
        f"occluded, equal to the CPU's")
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

    # The radiance family on phase G's ten-frame cube (its JPEG cam0images).
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
    # The same radiance from the workdirs' PNG frames: the JPEG cam0images' loss.
    res, secs, times, peak, grown = post_cli(["radiance", gnc, "--wassdir", str(root / "smoke_loop")], dev=dev)
    with hdf5.H5File(gnc) as f:
        diff = np.abs(f["radiance_cam0"][...].astype(np.float64) - rad)
    log(f"phase S radiance from the JPEG cam0images against the --wassdir PNG frames ({secs:.2f} s): max |diff| "
        f"{diff.max():.6f}, mean {diff.mean():.7f}, {100 * np.mean(diff > 1 / 255):.3f}% of the cells over one grey "
        "level")
    log(f"phase S: post times on {card}")
    log(f"phase S: {time.time() - t_phase:.1f} s wall")
    return launches


H5_FIXTURES = ROOT / "tests" / "torch_h5_fixtures"
H5_CUBE = "netcdfc_cube.nc"  # the netCDF-C-like cube of the fixtures
H5_REFUSED = {"unsupported.h5": {"/lzf": "filter 32000 (lzf)", "/scaleoffset": "filter 6 (scaleoffset)"}}
H5_COMMANDS = (["info"], ["spectrum", "--nperseg", "32", "--rangespan", "3"], ["visibilitymap"], ["zeromean"])
REF_CHUNK = (512, 128, 128)  # the reference's Z chunk (netcdfoutput.py:85)


def read_whole(path) -> list:
    """(dataset path, decoded bytes, host ms) of reading every dataset of
    the file at path whole, the file opened anew (the best of 3)."""
    from wass_tpu_torch.io import hdf5

    best: dict = {}
    for _ in range(3):
        with hdf5.H5File(path) as f:
            names = []
            f.visititems(lambda n, o: names.append("/" + n) if isinstance(o, hdf5.H5Dataset) else None)
            for n in names:
                if n in H5_REFUSED.get(Path(path).name, {}):
                    continue
                t0 = time.perf_counter()
                v = f[n][()]
                ms = 1e3 * (time.perf_counter() - t0)
                nbytes = sum(len(e) for e in v.ravel()) if v.dtype == object else v.nbytes
                best[n] = (nbytes, min(ms, best.get(n, (0, float("inf")))[1]))
    return [(n, b, ms) for n, (b, ms) in best.items()]


def run_h5_phase(root: Path, card: str, dev="cuda") -> dict:
    """Phase H: the HDF5 fixtures against their manifest, read times, then
    the post console on the netCDF-C-like cube and on its port-layout
    copy.  Returns visibilitymap's launches."""
    import zlib

    import numpy as np

    import wass_tpu_torch
    from wass_tpu_torch.io import hdf5, hdf5_index
    from wass_tpu_torch.testing.h5_manifest import file_manifest

    t_phase = time.time()
    manifest = json.loads((H5_FIXTURES / "MANIFEST.json").read_text())
    for name, want in manifest.items():
        refused = H5_REFUSED.get(name, {})
        got = file_manifest(H5_FIXTURES / name, refused=tuple(refused))
        if got != want:
            bad = [k for k in want["datasets"] if got["datasets"].get(k) != want["datasets"][k]]
            bad += [k for k in want["attrs"] if got["attrs"].get(k) != want["attrs"][k]]
            raise AssertionError(f"phase H: {name} differs from its manifest at {bad[:8]}")
        with hdf5.H5File(H5_FIXTURES / name) as f:
            for path, filt in refused.items():
                try:
                    f[path][()]
                except hdf5.LayoutError as e:
                    if filt not in str(e):
                        raise AssertionError(f"phase H: {name}{path} refused without naming {filt}: {e}")
                else:
                    raise AssertionError(f"phase H: {name}{path} read although its filter is not supported")
        n_sums = len(want["datasets"]) + sum(len(v) for v in want["attrs"].values())
        log(f"phase H: {name} ({(H5_FIXTURES / name).stat().st_size} bytes) reads as h5py wrote it: {n_sums} sha256 "
            f"of datasets and attributes matched" + (f", {', '.join(refused)} refused naming the filter" if refused
                                                     else ""))
    for name in manifest:
        rows = read_whole(H5_FIXTURES / name)
        total_b, total_ms = sum(r[1] for r in rows), sum(r[2] for r in rows)
        parts = [f"{n} {ms:.2f} ms ({b} B, {b / ms / 1e3:.1f} MB/s)" for n, b, ms in rows if ms > 0]
        log(f"phase H read {name}: {total_ms:.2f} ms for {total_b} decoded bytes in {len(rows)} datasets "
            f"({total_b / total_ms / 1e3:.1f} MB/s, host)" + ("; " + "; ".join(parts) if len(parts) <= 30 else ""))
    # One chunk of the reference's size through the filter pipeline.
    rng = np.random.default_rng(14)
    t = np.arange(REF_CHUNK[0])[:, None, None] / 15.0
    y, x = np.mgrid[:REF_CHUNK[1], :REF_CHUNK[2]] * 0.1
    z = np.zeros(REF_CHUNK, np.float32)
    for k, th, a, ph in zip(rng.uniform(0.3, 1.5, 6), rng.normal(0, 0.5, 6), rng.uniform(20, 120, 6),
                            rng.uniform(0, 6.28, 6)):
        z += (a * np.cos(k * np.cos(th) * x + k * np.sin(th) * y + ph - np.sqrt(9.81 * k) * t)).astype(np.float32)
    raw = z.tobytes()
    packed = zlib.compress(np.frombuffer(raw, np.uint8).reshape(-1, 4).T.tobytes(), 4)
    pipeline = [hdf5_index.Filter(2, (4,)), hdf5_index.Filter(1, (4,))]
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = hdf5_index.unfilter(packed, pipeline, 0, "reference chunk")
        times.append(time.perf_counter() - t0)
    if out != raw:
        raise AssertionError("phase H: the reference-size chunk does not decode to its bytes")
    log(f"phase H filter pipeline on one {REF_CHUNK} float32 chunk (shuffle, deflate level 4; {len(raw)} bytes, "
        f"{len(packed)} stored): {1e3 * min(times):.1f} ms, {len(raw) / min(times) / 1e6:.1f} MB/s decoded (host, "
        f"{card})")

    # The post console on the cube and on its port-layout copy.
    work = root / "smoke_h5"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cubes = (work / "netcdfc.nc", work / "port_layout.nc")
    shutil.copy(H5_FIXTURES / H5_CUBE, cubes[0])
    t0 = time.perf_counter()
    hdf5.copy_to_port_layout(H5_FIXTURES / H5_CUBE, cubes[1])
    log(f"phase H: copy_to_port_layout of {H5_CUBE} in {1e3 * (time.perf_counter() - t0):.1f} ms")
    launches = {}
    for cmd in H5_COMMANDS:
        outs, secs = [], []
        for nc in cubes:
            wass_tpu_torch.reset_launch_counts()
            with plot_capture() as plots:
                res, sec, _, _, _ = post_cli([cmd[0], str(nc), *cmd[1:]], dev=dev)
            if cmd[0] == "visibilitymap" and nc is cubes[0]:
                launches = wass_tpu_torch.launch_counts()
            if cmd[0] == "spectrum":
                check_plots(plots, {"spectrum.png": nc.with_suffix(".spectrum.png")}, "H", card)
            lines = [ln.replace(str(nc.with_suffix("")), "NC") for ln in res.splitlines()
                     if not ln.startswith("converted ")]
            # info lists meta's attributes in h5py's order: creation order in
            # the netCDF-C-like cube, names in the port's layout.
            meta = sorted(ln for ln in lines if ln.startswith("  meta."))
            outs.append([ln for ln in lines if not ln.startswith("  meta.")] + meta)
            secs.append(sec)
        if outs[0] != outs[1]:
            raise AssertionError(f"phase H {cmd[0]}: stdout differs between the two layouts: {outs}")
        if cmd[0] == "spectrum":
            for suffix in (".spectrum.csv", ".spectrum.png"):
                if cubes[0].with_suffix(suffix).read_bytes() != cubes[1].with_suffix(suffix).read_bytes():
                    raise AssertionError(f"phase H spectrum: {suffix} differs between the two layouts")
        log(f"phase H {' '.join(cmd)}: {secs[0]:.2f} s on the netCDF-C-like cube, {secs[1]:.2f} s on its port-layout "
            f"copy, the same output ({outs[0][-1] if outs[0] else ''})")
    digests = [file_manifest(nc) for nc in cubes]
    if digests[0] != digests[1]:
        bad = [k for k in digests[0]["datasets"] if digests[0]["datasets"][k] != digests[1]["datasets"].get(k)]
        raise AssertionError(f"phase H: after the edits the two cubes differ at {bad[:8]}")
    if launches.get("visibility_batch", 0) < 1:
        raise AssertionError(f"phase H: visibilitymap launched no visibility kernel: {launches}")
    log(f"phase H: after visibilitymap and zeromean both cubes hold the same {len(digests[0]['datasets'])} datasets "
        f"and {sum(len(v) for v in digests[0]['attrs'].values())} attributes (sha256); visibilitymap launched the "
        f"fused kernel {launches['visibility_batch']} times")
    log(f"phase H: {time.time() - t_phase:.1f} s wall")
    return launches


SHARDED_SLOTS = 2  # phase D (a): frame slots on cuda:0 in one process; (b): two ranks, one slot each
SHARDED_DEVICE = "cuda:0"  # the card of phase D's slots
ONE_PROCESS_BACKEND = "nccl"  # phase D (a)'s process group of world size 1
RANKS_TIMEOUT = 300  # seconds for the two ranks of phase D (b)
# The sharded BA against the unsharded one, the limits of
# tests/test_torch_parallel.py: float32 R and T's direction (the pose
# autocalibrate keeps) within 5e-5 and T within 1e-4 (|T| is the gauge, set
# by the damping's path); float64 R and T within 1e-10.
BA_TOL = {"float32": (5e-5, 5e-5, 1e-4), "float64": (1e-10, 1e-10, 1e-10)}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def seq_files(seq: Path) -> dict:
    """Bytes of each frame's mesh_cam.xyzC and plane.txt and of
    output/planes.txt, by path under seq."""
    files = {f"{wd.name}/{f}": (wd / f).read_bytes() for wd in sorted(seq.glob("*_wd"))
             for f in ("mesh_cam.xyzC", "plane.txt")}
    files["output/planes.txt"] = (seq / "output" / "planes.txt").read_bytes()
    return files


def seq_logs(seq: Path) -> dict:
    """Each frame's wass_stereo_log.txt without its finalize wall time line,
    by path under seq."""
    return {f"{wd.name}/wass_stereo_log.txt": [ln for ln in (wd / "wass_stereo_log.txt").read_text().splitlines()
                                               if "finalize wall time" not in ln]
            for wd in sorted(seq.glob("*_wd"))}


def same_files(a: dict, b: dict, what: str) -> None:
    differ = sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))
    if differ:
        raise AssertionError(f"{what}: {differ[:6]} differ ({len(differ)} files)")
    log(f"{what}: {len(a)} files byte-equal")


def pooled_ba_problem(root: Path, dev, n_slots: int) -> dict:
    """Phase M's pooled matches (matches_epionly.txt of the POOL_SEEDS
    workdirs) as a BA problem at the pooled extrinsics, as autocalibrate
    builds it: normalized observations, the points triangulated on the
    card, those in front within the RANSAC threshold (Sampson distance)
    kept, padded to a multiple of n_slots with masked rows at (0, 0, 1);
    float32 numpy."""
    import numpy as np
    import torch

    from wass_tpu_torch.calib.autocalibrate import AutocalConfig
    from wass_tpu_torch.core.triangulate import triangulate_normalized
    from wass_tpu_torch.io.workdir import frame_workdirs
    from wass_tpu_torch.parallel.distba import pad_points_for_mesh

    wds = frame_workdirs(root / "smoke_pool")
    K0, K1 = wds[0].load_intrinsics(0), wds[0].load_intrinsics(1)
    R, T = wds[0].load_extrinsics()
    R, T = np.asarray(R, np.float64), np.asarray(T, np.float64).reshape(3)
    uv = [wd.load_matches("matches_epionly.txt") for wd in wds]
    uv0, uv1 = np.concatenate([u[0] for u in uv]), np.concatenate([u[1] for u in uv])
    x0 = np.c_[uv0, np.ones(len(uv0))] @ np.linalg.inv(K0).T
    x1 = np.c_[uv1, np.ones(len(uv1))] @ np.linalg.inv(K1).T
    E = np.array([[0, -T[2], T[1]], [T[2], 0, -T[0]], [-T[1], T[0], 0]]) @ R
    Ex0, Etx1 = x0 @ E.T, x1 @ E
    sampson = np.abs(np.sum(x1 * Ex0, -1)) / np.sqrt(Ex0[:, 0] ** 2 + Ex0[:, 1] ** 2 + Etx1[:, 0] ** 2 + Etx1[:, 1] ** 2)
    p0, p1 = x0[:, :2].astype(np.float32), x1[:, :2].astype(np.float32)
    R32, T32 = R.astype(np.float32), T.astype(np.float32)
    X = triangulate_normalized(*(torch.from_numpy(a).to(dev) for a in (p0, p1, R32, T32))).cpu().numpy()
    keep = np.isfinite(X).all(1) & (X[:, 2] > 0) & (sampson * K0[0, 0] < AutocalConfig().ransac_threshold_px)
    (X, p0, p1), mask = pad_points_for_mesh([X[keep], p0[keep], p1[keep]], np.ones(int(keep.sum()), bool), n_slots)
    X[~mask] = (0.0, 0.0, 1.0)
    return {"R": R32, "T": T32, "X": X, "p0": p0, "p1": p1, "mask": mask}


def ba_agrees(a, b, what: str, dtype: str = "float32") -> str:
    """R, T's direction and T of two BA results (R, T) within BA_TOL[dtype],
    or raise."""
    import numpy as np

    Ra, Ta, Rb, Tb = (np.asarray(x.cpu() if hasattr(x, "cpu") else x, np.float64) for x in (a[0], a[1], b[0], b[1]))
    dr = np.abs(Ra - Rb).max()
    dd = np.abs(Ta / np.linalg.norm(Ta) - Tb / np.linalg.norm(Tb)).max()
    dt = np.abs(Ta - Tb).max()
    tol_r, tol_d, tol_t = BA_TOL[dtype]
    if not (dr <= tol_r and dd <= tol_d and dt <= tol_t):
        raise AssertionError(f"{what} ({dtype}): |dR| {dr}, |d T/|T|| {dd}, |dT| {dt} (limits {BA_TOL[dtype]})")
    bits = "bit-equal" if np.array_equal(Ra, Rb) and np.array_equal(Ta, Tb) else "not bit-equal"
    return (f"{dtype} max |dR| {dr:.3g}, |d T/|T|| {dd:.3g}, |dT| {dt:.3g} (limits {tol_r:g}, {tol_d:g}, "
            f"{tol_t:g}; {bits})")


def run_sharded_one_process(root: Path, scene, dev, card: str, loop_rates: dict) -> tuple:
    """Phase D (a): one process in an NCCL group of world size 1, a frame
    mesh of SHARDED_SLOTS slots on cuda:0.  Returns (the launches, the
    float32 sharded BA's R and T)."""
    import numpy as np
    import torch.distributed as dist

    import wass_tpu_torch
    from wass_tpu_torch import instrument
    from wass_tpu_torch.calib.ba import lm_refine_two_view
    from wass_tpu_torch.cli import pipeline as pipeline_mod
    from wass_tpu_torch.cli.main import load_pipeline
    from wass_tpu_torch.parallel import runner as prun
    from wass_tpu_torch.parallel.distba import lm_refine_two_view_sharded
    from wass_tpu_torch.parallel.mesh import make_frame_mesh
    from wass_tpu_torch.stereo import dense
    from wass_tpu_torch.testing import write_sequence

    rig = scene.rig
    totals: dict = {}
    prun.initialize_multihost(f"localhost:{free_port()}", 1, 0, backend=ONE_PROCESS_BACKEND)
    try:
        seq = root / "smoke_sharded"
        write_sequence(seq, scene.img0, scene.img1, rig, LOOP_FRAMES)
        pipe = load_pipeline(seq)
        pipe._frame_mesh = lambda: make_frame_mesh(devices=[SHARDED_DEVICE] * SHARDED_SLOTS)
        rates = []
        for rep in range(2):
            wass_tpu_torch.reset_launch_counts()
            t0 = time.time()
            pipe.stereo(progress_stream=io.StringIO())
            rates.append(LOOP_FRAMES / (time.time() - t0))
            if rep == 0:
                add_counts(totals, wass_tpu_torch.launch_counts())
        one_slot = loop_rates.get((3, 2, True), [])
        log(f"phase D (a) on {card}: SequencePipeline.stereo on {SHARDED_SLOTS} slots on cuda:0, each dispatching from "
            f"a thread of its own, in an NCCL group of world size 1, {LOOP_FRAMES} frames a pass (renders on): frames/s "
            f"{' '.join(f'{r:.4f}' for r in rates)}; phase 5's one slot at (3, 2), renders on: "
            f"{' '.join(f'{r:.4f}' for r in one_slot)} (the first pass of each includes the warm-up; slots sharing one "
            f"card: a record of overlap on one device, not a scaling number); launches {totals}")
        for i, wd in enumerate(sorted(seq.glob("*_wd"))):
            per_frame = check_frame(f"two-slot {i}", wd, scene, WINDOWED_PATH, gate=True)
            if not c2f_line(wd).endswith("windowed"):
                raise AssertionError(f"two-slot frame {i}: launches {per_frame}, {c2f_line(wd)!r}")
        same_files(seq_files(seq), seq_files(root / "smoke_loop"), "phase D (a): the two slots' frames against "
                   "phase 5's one-slot frames")
        same_files(seq_logs(seq), seq_logs(root / "smoke_loop"), "phase D (a): the two slots' logs (but the wall time "
                   "line) against phase 5's")

        # Frame 1 of a 2-frame sequence forced to the full-range fallback in
        # the writers: the writer's decision and resolve_fallback's.
        fb = root / "smoke_sharded_fallback"
        write_sequence(fb, scene.img0, scene.img1, rig, 2)
        decide = dense.c2f_should_fallback

        def forced(cov, offb, cfg):
            return instrument.current().index == 1 or decide(cov, offb, cfg)

        pipeline_mod.c2f_should_fallback = dense.c2f_should_fallback = forced
        try:
            pipe = load_pipeline(fb)
            pipe._frame_mesh = lambda: make_frame_mesh(devices=[SHARDED_DEVICE] * SHARDED_SLOTS)
            wass_tpu_torch.reset_launch_counts()
            pipe.stereo(progress_stream=io.StringIO())
            add_counts(totals, wass_tpu_torch.launch_counts())
        finally:
            pipeline_mod.c2f_should_fallback = dense.c2f_should_fallback = decide
        per_frame = check_frame("two-slot fallback 1", fb / "000001_wd", scene, WINDOWED_PATH, gate=True)
        if not c2f_line(fb / "000001_wd").endswith("FALLBACK to full-range SGM") or per_frame["label_propagate"] != 2:
            raise AssertionError(f"forced fallback frame: {c2f_line(fb / '000001_wd')!r}, launches {per_frame}")
        files = seq_files(fb)
        same_files({k: v for k, v in files.items() if k.startswith("000001_wd/")},
                   {f"000001_wd/{f}": (root / "smoke_full_range" / "000000_wd" / f).read_bytes()
                    for f in ("mesh_cam.xyzC", "plane.txt")}, "phase D (a): the forced fallback frame against "
                   "phase 4b's c2f_window = 0 frame")
        same_files({k: v for k, v in files.items() if k.startswith("000000_wd/")},
                   {k: v for k, v in seq_files(root / "smoke_loop").items() if k.startswith("000000_wd/")},
                   "phase D (a): the other slot's frame against phase 5's frame 0")
        log(f"phase D (a): frame 1's fallback forced in the writers, its launches {per_frame}")

        # The sharded BA on phase M's pooled matches.
        prob = pooled_ba_problem(root, dev, SHARDED_SLOTS)
        np.savez(root / "smoke_sharded_ba.npz", **prob)
        mesh = make_frame_mesh(devices=[SHARDED_DEVICE] * SHARDED_SLOTS)
        for dtype in ("float32", "float64"):
            cast = {k: (v.astype(dtype) if v.dtype.kind == "f" else v) for k, v in prob.items()}
            t0 = time.perf_counter()
            single = lm_refine_two_view(*(torch_on(cast[k], dev) for k in ("R", "T", "X", "p0", "p1", "mask")),
                                        max_iters=50)
            t_single = time.perf_counter() - t0
            t0 = time.perf_counter()
            shard = lm_refine_two_view_sharded(mesh, cast["R"], cast["T"], cast["X"], cast["p0"], cast["p1"],
                                               cast["mask"], max_iters=50)
            t_shard = time.perf_counter() - t0
            agree = ba_agrees((shard.R, shard.T), (single.R, single.T), "phase D (a) sharded BA", dtype)
            log(f"phase D (a) BA on phase M's {int(prob['mask'].sum())} pooled points: {SHARDED_SLOTS} shards "
                f"{shard.n_iters} LM steps {t_shard:.3f} s, unsharded {single.n_iters} steps {t_single:.3f} s; {agree}")
            if dtype == "float32":
                ba_ref = (shard.R.cpu().numpy(), shard.T.cpu().numpy())
        return totals, ba_ref
    finally:
        dist.destroy_process_group()


def torch_on(a, dev):
    import torch

    return torch.from_numpy(a).to(dev)


def run_sharded_ranks(root: Path, scene, ba_ref, card: str) -> None:
    """Phase D (b): two processes on the one card, one slot each, under
    gloo (NCCL refuses two ranks on one device), through a localhost TCP
    store: the same frames as (a) through stereo(), then the distributed
    BA across the two ranks."""
    import numpy as np

    from wass_tpu_torch.testing import write_sequence

    seq = root / "smoke_sharded_ranks"
    write_sequence(seq, scene.img0, scene.img1, scene.rig, LOOP_FRAMES)
    port = free_port()
    t0 = time.time()
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--sharded-rank", str(r), str(port),
                               str(seq), str(root / "smoke_sharded_ba.npz"), SHARDED_DEVICE], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=RANKS_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or f"RANK-OK {r}" not in out:
            raise AssertionError(f"phase D (b) rank {r} failed ({p.returncode}):\n{out[-3000:]}")
        for line in out.splitlines():
            if line.startswith(f"RANK-OK {r}"):
                log(f"phase D (b) rank {r}: {line[len(f'RANK-OK {r} '):]}")
    log(f"phase D (b) on {card}: two ranks (gloo, one slot each on cuda:0), {LOOP_FRAMES} frames, "
        f"{time.time() - t0:.1f} s wall with both processes' start (a record of two processes on one device, not a "
        f"scaling number)")
    for i, wd in enumerate(sorted(seq.glob("*_wd"))):
        check_frame(f"rank-sharded {i}", wd, scene, WINDOWED_PATH, gate=True)
    same_files(seq_files(seq), seq_files(root / "smoke_sharded"), "phase D (b): the two ranks' files (each rank its "
               "own frames, rank 0 planes.txt) against (a)'s")
    same_files(seq_logs(seq), seq_logs(root / "smoke_sharded"), "phase D (b): the two ranks' logs (but the wall "
               "time line) against (a)'s")
    for r in range(2):
        got = np.load(seq / f"ba_rank{r}.npz")
        log(f"phase D (b) BA rank {r} ({int(got['n_iters'])} LM steps) against (a)'s sharded BA: "
            + ba_agrees((got["R"], got["T"]), ba_ref, f"phase D (b) rank {r} BA"))


def sharded_rank(rank: int, port: int, seq: Path, ba_path: Path, device: str) -> int:
    """One rank of phase D (b) (chip_smoke.py --sharded-rank RANK PORT SEQ BA DEVICE)."""
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch.distributed as dist

    import wass_tpu_torch
    from wass_tpu_torch.cli.main import load_pipeline
    from wass_tpu_torch.parallel.distba import lm_refine_two_view_sharded
    from wass_tpu_torch.parallel.mesh import make_frame_mesh
    from wass_tpu_torch.parallel.runner import initialize_multihost

    # NCCL refuses two ranks on one device: the two ranks share cuda:0 under gloo.
    initialize_multihost(f"localhost:{port}", 2, rank, backend="gloo")
    try:
        pipe = load_pipeline(seq)  # default_devices(): each rank's card is cuda:0 (rank % 1)
        wass_tpu_torch.reset_launch_counts()
        t0 = time.time()
        pipe.stereo(progress_stream=io.StringIO())
        wall = time.time() - t0
        launches = {k: v for k, v in wass_tpu_torch.launch_counts().items() if v}
        prob = np.load(ba_path)
        rows = len(prob["mask"]) // 2
        part = {k: prob[k][rank * rows:(rank + 1) * rows] for k in ("X", "p0", "p1", "mask")}
        ba = lm_refine_two_view_sharded(make_frame_mesh(devices=[device]), prob["R"], prob["T"], part["X"],
                                        part["p0"], part["p1"], part["mask"], max_iters=50)
        np.savez(seq / f"ba_rank{rank}.npz", R=ba.R.cpu().numpy(), T=ba.T.cpu().numpy(), n_iters=ba.n_iters)
    finally:
        dist.destroy_process_group()
    print(f"RANK-OK {rank} stereo {wall:.2f} s for its {LOOP_FRAMES // 2} frames (with the other rank's on the same "
          f"card), launches {launches}", flush=True)
    return 0


def check_other_card(scene, card: str) -> None:
    """Phase D (c): with more than one card, a frame on the last card
    bit-equal to the frame on cuda:0."""
    import torch

    from wass_tpu_torch.stereo.dense import DenseStereoConfig, dense_stereo_frame

    n = torch.cuda.device_count()
    if n < 2:
        log(f"phase D (c): {n} card here; holding a frame on another card against cuda:0 needs two cards "
            "(this line is not a caught failure)")
        return
    rig = scene.rig
    out = [dense_stereo_frame(scene.img0, scene.img1, rig.K0, rig.K1, rig.R, rig.T, DenseStereoConfig(),
                              device=f"cuda:{k}")[0] for k in (0, n - 1)]
    for name, a, b in zip(out[0]._fields, *out):
        if isinstance(a, torch.Tensor) and not torch.equal(a.cpu(), b.cpu()):
            raise AssertionError(f"phase D (c): {name} of the frame on cuda:{n - 1} differs from cuda:0's")
    log(f"phase D (c): the frame on cuda:{n - 1} bit-equal to cuda:0's ({card})")


def run_sharded_phase(root: Path, scene, dev, card: str, loop_rates: dict) -> dict:
    """Phase D: (a) two slots and the sharded BA in one process, (b) two
    ranks, (c) another card.  Returns the launches of (a)."""
    t0 = time.time()
    launches, ba_ref = run_sharded_one_process(root, scene, dev, card, loop_rates)
    run_sharded_ranks(root, scene, ba_ref, card)
    check_other_card(scene, card)
    log(f"phase D: {time.time() - t0:.1f} s wall")
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
    import numpy as np
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
    from wass_tpu_torch.io.image import codec_report

    log("phase I codecs: " + "; ".join(codec_report()))

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
    check_jpeg(results, rect, dev, smi)

    # Phase 4: the main path; 4b: the other branches; 4c: the H2 frames.
    seq = _build.BUILD_DIR / "smoke_seq"
    write_sequence(seq, img0, img1, rig, N_FRAMES)
    with frame0_renders() as kept:
        launches = run_main_path(seq, scene)
    check_render_files(sorted(seq.glob("*_wd")), STEREO_RENDERS, "stereo renders of phase 4")
    check_frame0_renders(kept, seq / "000000_wd", smi)
    del kept
    for phase in (run_branches, run_h2_frames):
        add_counts(launches, phase(_build.BUILD_DIR, img0, img1, rig, scene))
    # Phase P: prepare on the card, then stereo on the prepared frames.
    add_counts(launches, run_prepare(_build.BUILD_DIR, rig, scene))
    # Phase M: match and autocalibrate on the card, then stereo with the recovered extrinsics.
    add_counts(launches, run_match_phase(_build.BUILD_DIR, scene, results, dev, smi))
    check_render_files(sorted((_build.BUILD_DIR / "smoke_match").glob("*_wd")), MATCH_RENDERS,
                       "match renders of phase M")

    # Phase 5: where the c2f frame's time goes.
    loop_rates = profile_c2f_frame(_build.BUILD_DIR, img0, img1, rig)
    # Phase F: the optical flow on phase 5's frames.
    add_counts(launches, run_flow_phase(_build.BUILD_DIR, img0, img1, rig, scene, results, smi, loop_rates))
    # Phase G: the grid stage on phase 5's frames.
    run_grid_phase(_build.BUILD_DIR, scene, smi)
    # Phase S: the post stage on a cube of phase G's grid.
    add_counts(launches, run_post_phase(_build.BUILD_DIR, scene, results, smi))
    # Phase H: the HDF5 layouts of h5py and netCDF-C, and the post console on them.
    add_counts(launches, run_h5_phase(_build.BUILD_DIR, smi))
    # Phase I: image IO (the renders and codecs were checked above).
    t0 = time.time()
    check_decode(np.clip(img0, 0, 255).astype(np.uint8), _build.BUILD_DIR, smi)
    add_counts(launches, check_raw_forms(_build.BUILD_DIR, rig, scene))
    check_stokes(_build.BUILD_DIR, rig, dev)
    log(f"phase I: {time.time() - t0:.1f} s wall")
    # Phase D: the frame-sharded path and the two-rank run.
    add_counts(launches, run_sharded_phase(_build.BUILD_DIR, scene, dev, smi, loop_rates))
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
    if sys.argv[1:2] == ["--sharded-rank"]:  # one rank of phase D (b), started by phase D
        sys.exit(sharded_rank(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]), Path(sys.argv[5]), sys.argv[6]))
    sys.exit(main())
