"""Port parity: morphology and sampling (wass_tpu_torch/ops) against the JAX
package on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wass_tpu.ops import morphology as jmorph
from wass_tpu.ops import sampling as jsamp
from wass_tpu_torch.ops import morphology as tmorph
from wass_tpu_torch.ops import sampling as tsamp


def _disp(rng, h=40, w=56):
    d = (rng.random((h, w)) * 30 + 1).astype(np.float32)
    d[rng.random((h, w)) < 0.3] = 0.0
    return d


def _smooth(rng, h=48, w=64):
    yy, xx = np.mgrid[0:h, 0:w]
    return (100 + 60 * np.sin(xx / 5.0) * np.cos(yy / 7.0) + 20 * rng.random((h, w))).astype(np.float32)


@pytest.mark.parametrize("name", ["dilate_zero", "erode_zero"])
def test_zero_morphology_bit_equal(rng, name):
    d = _disp(rng)
    ref = np.asarray(getattr(jmorph, name)(jnp.asarray(d)))
    out = getattr(tmorph, name)(torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("ksize", [3, 5])
def test_median_bit_equal(rng, ksize):
    d = _disp(rng)
    np.testing.assert_array_equal(
        tmorph.median_filter(torch.from_numpy(d), ksize).numpy(), np.asarray(jmorph.median_filter(jnp.asarray(d), ksize))
    )


@pytest.mark.parametrize("axis", [0, 1])
def test_sobel(rng, axis):
    d = _disp(rng)
    np.testing.assert_allclose(
        tmorph.sobel(torch.from_numpy(d), axis).numpy(), np.asarray(jmorph.sobel(jnp.asarray(d), axis)), rtol=0, atol=1e-4
    )


@pytest.mark.parametrize("sampler", ["bilinear_sample", "bicubic_sample"])
def test_samplers(rng, sampler):
    img = _smooth(rng)
    x = (rng.random((30, 20)) * 70 - 3).astype(np.float32)
    y = (rng.random((30, 20)) * 54 - 3).astype(np.float32)
    ref = np.asarray(getattr(jsamp, sampler)(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y)))
    out = getattr(tsamp, sampler)(torch.from_numpy(img), torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)


@pytest.mark.parametrize("interp", ["linear", "cubic"])
def test_warp_homography(rng, interp):
    """<= 1e-3 abs: the inverse homography is a float32 solve in both
    packages, by different routines."""
    img = _smooth(rng)
    Hm = np.array([[1.02, 0.03, -2.5], [-0.01, 0.98, 1.5], [1e-4, -2e-4, 1.0]], np.float32)
    ref = np.asarray(jsamp.warp_homography(jnp.asarray(img), jnp.asarray(Hm), (44, 60), interp=interp))
    out = tsamp.warp_homography(torch.from_numpy(img), torch.from_numpy(Hm), (44, 60), interp=interp).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)


@pytest.mark.parametrize("interp", ["nearest", "linear", "cubic"])
@pytest.mark.parametrize("shape", [(24, 32), (96, 128), (37, 53)])
def test_resize(rng, interp, shape):
    img = _smooth(rng)
    ref = np.asarray(jsamp.resize(jnp.asarray(img), shape, interp=interp))
    out = tsamp.resize(torch.from_numpy(img), shape, interp=interp).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)
