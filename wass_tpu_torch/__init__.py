"""wass_tpu_torch — the PyTorch/CUDA port of wass_tpu's dense-stereo path.

The JAX package `wass_tpu` stays the reference; this package mirrors its
layout (`stereo/cost.py` <-> `wass_tpu/stereo/cost.py`, ...) and runs the
full-range dense stereo stage with known extrinsics on an NVIDIA H100:

  cli/       argparse entry point and the sequence stereo loop
  stereo/    census, cost volume, SGM, plane fit, the dense frame pipeline
  ops/       sampling, morphology, connected components
  core/      geometry, triangulation, rectification (host, float64)
  prepare/   input-degradation estimate (AUTO smoothing sigma)
  io/        stdlib PNG codec
  testing/   smoke-run helpers around the synthetic wave-field scenes
  csrc/      the hand-written CUDA kernels (K1 cost, K3 SGM+WTA, K7 labels)

Kernel wrappers launch the CUDA kernel for CUDA tensors and run the plain
PyTorch version for CPU tensors only.  This package never imports jax.
It shares the JAX package's jax-free host modules (wass_tpu.io for
workdirs, .xyzC and matrix files, wass_tpu.config for the option
registry, wass_tpu.testing for the synthetic scenes) and nothing else of
it; images go through the port's own PNG codec.
"""

from wass_tpu_torch import device as device  # noqa: F401  (sets the TF32 switches)

__version__ = "0.1.0"


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    from wass_tpu_torch.ops import components_kernels
    from wass_tpu_torch.stereo import sgm_kernels

    return {**sgm_kernels.LAUNCHES, **components_kernels.LAUNCHES}


def reset_launch_counts() -> None:
    from wass_tpu_torch.ops import components_kernels
    from wass_tpu_torch.stereo import sgm_kernels

    for counts in (sgm_kernels.LAUNCHES, components_kernels.LAUNCHES):
        for k in counts:
            counts[k] = 0
