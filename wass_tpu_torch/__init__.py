"""wass_tpu_torch — the PyTorch/CUDA port of wass_tpu.

The JAX package `wass_tpu` stays the reference; this package mirrors its
layout (`stereo/cost.py` <-> `wass_tpu/stereo/cost.py`, ...) and runs the
prepare, match, autocalibrate, dense stereo (coarse-to-fine search and
full-range fallback included), gridding and post stages on an NVIDIA H100:

  cli/       argparse entry points (prepare, match, autocalibrate, stereo,
             genconfig; gridsurface; post) and the sequence pipeline: prepare,
             match, autocalibrate, and the production stereo loop (PNG
             prefetch, dispatch ahead, writer threads)
  grid/      grid setup (config.mat), per-frame gridding on the device
             (median stack, DCT/IDW/LinearND fill, outlier votes) and the
             gridded.nc cube
  post/      the post stage over gridded cubes: spectra, filters, the
             visibility ray march, radiance, polarimetric averages, and
             the out-of-core streaming under a memory budget
  match/     features, candidates and payoff, the game-theoretic rounds
             (iidyn), LK refinement, relative-pose RANSAC, the frame stage
  calib/     two-view bundle adjustment, the Sampson polish, the pooled
             sequence autocalibration
  stereo/    census, cost volumes, SGM, coarse-to-fine windows, plane fit,
             the dense frame pipeline
  ops/       sampling and undistortion, morphology, connected components
  core/      geometry, epipolar errors, triangulation, rectification
  prepare/   the prepare stage (CLAHE, undistortion, the polarimetric
             path) and the input-degradation estimate (AUTO smoothing)
  config.py  the self-registering option registry
  launches.py  thread-safe kernel launch counts, per frame
  io/        stdlib PNG codec and its prefetcher, workdirs, .xyzC, matrices,
             a minimal HDF5 writer, reader and editor (the cube without h5py)
  utils/     the [P|cur|tot] progress line, the stage timer
  testing/   synthetic wave-field scenes and smoke-run helpers
  csrc/      the hand-written CUDA kernels (K1/K2 cost volumes, K3/K4 SGM+WTA,
             K5/K6 SGM sums, the H2 pair and folding walks, K7 labels,
             the iidyn loop, the visibility ray march)

Kernel wrappers launch the CUDA kernel for CUDA tensors and run the plain
PyTorch version for CPU tensors only.  This package never imports jax.
Nor does it import anything of the JAX package: it keeps its own copies
of the host modules it needs (config.py, the option registry; io/ for
workdirs, .xyzC and matrix files beside its stdlib PNG codec;
testing/synthetic.py for the synthetic scenes).
"""

from wass_tpu_torch import device as device  # noqa: F401  (sets the TF32 switches)

__version__ = "0.1.0"


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    from wass_tpu_torch.match import iidyn
    from wass_tpu_torch.ops import components_kernels
    from wass_tpu_torch.post import visibility_kernels
    from wass_tpu_torch.stereo import sgm_kernels

    return {**sgm_kernels.LAUNCHES, **components_kernels.LAUNCHES, **iidyn.LAUNCHES, **visibility_kernels.LAUNCHES}


def reset_launch_counts() -> None:
    from wass_tpu_torch.match import iidyn
    from wass_tpu_torch.ops import components_kernels
    from wass_tpu_torch.post import visibility_kernels
    from wass_tpu_torch.stereo import sgm_kernels

    for counts in (sgm_kernels.LAUNCHES, components_kernels.LAUNCHES, iidyn.LAUNCHES, visibility_kernels.LAUNCHES):
        counts.reset()
