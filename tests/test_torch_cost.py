"""Port parity: census transform, popcount and the plain census cost volume
(wass_tpu_torch/stereo/cost.py, the K1 wrapper on CPU tensors) against the
JAX package on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wass_tpu.match.features import _gauss_blur
from wass_tpu.stereo import cost as jcost
from wass_tpu.stereo.sgm_pallas import census_cost_volume_pallas
from wass_tpu_torch.stereo import cost as tcost
from wass_tpu_torch.stereo import sgm_kernels


def _img(rng, h, w):
    return (rng.random((h, w)) * 255).astype(np.float32)


def _as_u32(words: torch.Tensor) -> np.ndarray:
    return words.numpy().view(np.uint32)


def _as_port_words(words) -> torch.Tensor:
    return torch.from_numpy(np.asarray(words).view(np.int32).copy())


@pytest.mark.parametrize("win", [(7, 9), (5, 5), (3, 7)])
def test_census_bit_equal_unsmoothed(rng, win):
    img = _img(rng, 40, 56)
    ref = np.asarray(jcost.census_transform(jnp.asarray(img), win, 0.0))
    out = _as_u32(tcost.census_transform(torch.from_numpy(img), win, 0.0))
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("sigma", [0.8, -1.0])
def test_census_smoothed(rng, sigma):
    """Blur within 1e-5 abs, >= 99.99% of the census words equal (the two
    blurs may sum taps in another order); -1 is the AUTO sentinel (0.8)."""
    img = _img(rng, 48, 64)
    blur_ref = np.asarray(_gauss_blur(jnp.asarray(img), 0.8))
    blur = tcost.gauss_blur(torch.from_numpy(img), 0.8).numpy()
    np.testing.assert_allclose(blur, blur_ref, rtol=0, atol=1e-5)
    ref = np.asarray(jcost.census_transform(jnp.asarray(img), (7, 9), sigma))
    out = _as_u32(tcost.census_transform(torch.from_numpy(img), (7, 9), sigma))
    assert (out == ref).mean() >= 0.9999


def test_blur_wide_kernel(rng):
    """sigma 1.5 (the noisy-input AUTO choice, 11 taps): float32 rounding of
    a differently ordered sum, <= 1e-6 relative."""
    img = _img(rng, 40, 50)
    ref = np.asarray(_gauss_blur(jnp.asarray(img), 1.5))
    out = tcost.gauss_blur(torch.from_numpy(img), 1.5).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-5)


def test_popcount32(rng):
    x = rng.integers(0, 2**32, size=1000, dtype=np.uint64).astype(np.uint32)
    ref = np.array([bin(int(v)).count("1") for v in x])
    out = tcost.popcount32(torch.from_numpy(x.view(np.int32).copy())).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("num_disp,min_disp,height", [(32, 1, 48), (36, 3, 48), (32, 1, 45), (36, 0, 37)])
def test_cost_volume_bit_equal(rng, num_disp, min_disp, height):
    """Plain cost volume == the JAX build and, where the Pallas kernel takes
    the shape (H % 8 == 0), its interpret-mode run, given JAX's words."""
    cb = jcost.census_transform(jnp.asarray(_img(rng, height, 64)), (7, 9))
    cm = jcost.census_transform(jnp.asarray(_img(rng, height, 64)), (7, 9))
    out = tcost.census_cost_volume(_as_port_words(cb), _as_port_words(cm), num_disp, min_disp).numpy()
    np.testing.assert_array_equal(out, np.asarray(jcost.census_cost_volume(cb, cm, num_disp, min_disp)))
    if height % 8 == 0:
        pal = census_cost_volume_pallas(cb, cm, num_disp, min_disp, interpret=True)
        np.testing.assert_array_equal(out, np.asarray(pal))


def test_cost_wrapper_runs_plain_on_cpu(rng):
    cb = tcost.census_transform(torch.from_numpy(_img(rng, 24, 40)), (7, 9))
    cm = tcost.census_transform(torch.from_numpy(_img(rng, 24, 40)), (7, 9))
    before = dict(sgm_kernels.LAUNCHES)
    out = sgm_kernels.census_cost_volume(cb, cm, 16, 1)
    assert torch.equal(out, tcost.census_cost_volume(cb, cm, 16, 1))
    assert sgm_kernels.LAUNCHES == before  # no kernel launch on CPU tensors


@pytest.mark.parametrize("win,sigma,shape", [((7, 9), 0.8, (40, 56)), ((7, 9), 0.0, (24, 32)),
                                             ((7, 9), -1.0, (37, 53)), ((5, 5), 1.7, (37, 53)),
                                             ((9, 9), 0.0, (5, 4))])
def test_census_wrapper_runs_plain_on_cpu(rng, win, sigma, shape):
    """The census kernel's wrapper on a CPU tensor is cost.census_transform
    itself, and counts no launch."""
    img = torch.from_numpy(_img(rng, *shape))
    before = dict(sgm_kernels.LAUNCHES)
    out = sgm_kernels.census_transform(img, win, sigma)
    assert torch.equal(out, tcost.census_transform(img, win, sigma))
    assert sgm_kernels.LAUNCHES == before and "census" in before


def test_cost_rejects_negative_min_disp(rng):
    cb = tcost.census_transform(torch.from_numpy(_img(rng, 8, 16)), (3, 3))
    with pytest.raises(ValueError):
        tcost.census_cost_volume(cb, cb, 4, -1)


@pytest.mark.parametrize("devices", [("meta", "meta"), ("cpu", "meta")])
def test_wrappers_reject_devices_other_than_cpu_and_one_cuda(devices):
    """A wrapper takes the plain version for CPU tensors only; any other
    device, or a mix, raises instead of falling back."""
    from wass_tpu_torch.ops import components_kernels

    a, b = (torch.zeros((4, 6, 2), dtype=torch.int32, device=d) for d in devices)
    with pytest.raises(ValueError, match="one CUDA device"):
        sgm_kernels.census_cost_volume(a, b, 4, 1)
    with pytest.raises(ValueError, match="one CUDA device"):
        sgm_kernels.sgm_wta_fused(b.to(torch.uint8), 8, 96, 8, 1)
    if devices[0] == devices[1]:
        with pytest.raises(ValueError, match="one CUDA device"):
            sgm_kernels.census_transform(b[..., 0].float(), (7, 9), 0.8)
    lab = a[..., 0]
    with pytest.raises(ValueError, match="one CUDA device"):
        components_kernels.propagate_labels(lab, b[..., 0].to(torch.uint8), b[..., 0].to(torch.uint8), 1)
