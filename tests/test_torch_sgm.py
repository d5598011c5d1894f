"""Port parity: plain SGM aggregation, WTA and the fused plain form
(wass_tpu_torch/stereo/sgm.py, the K3 wrapper on CPU tensors) against the
JAX scan path and the Pallas kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wass_tpu.stereo import cost as jcost
from wass_tpu.stereo import sgm as jsgm
from wass_tpu.stereo.sgm_pallas import sgm_aggregate_pallas, sgm_wta_fused_pallas
from wass_tpu_torch.stereo import sgm as tsgm
from wass_tpu_torch.stereo import sgm_kernels


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(7)
    img0 = (rng.random((48, 64)) * 255).astype(np.float32)
    img1 = (rng.random((48, 64)) * 255).astype(np.float32)
    return jcost.census_transform(jnp.asarray(img0), (5, 5)), jcost.census_transform(jnp.asarray(img1), (5, 5))


def _vol(pair, min_disp=1):
    return jcost.census_cost_volume(pair[0], pair[1], 32, min_disp)


@pytest.mark.parametrize("directions", [2, 4, 5, 8])
def test_aggregate_bit_equal(pair, directions):
    vol = _vol(pair)
    ref = np.asarray(jsgm.sgm_aggregate(vol, 8, 96, directions))
    out = tsgm.sgm_aggregate(torch.from_numpy(np.asarray(vol)), 8, 96, directions)
    assert out.dtype == torch.int16
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("directions", [2, 4, 5, 8])
def test_aggregate_plain_matches_pallas(pair, directions):
    """Plain K5 (sgm.sgm_aggregate, the K5 wrapper on CPU tensors) ==
    sgm_aggregate_pallas(interpret=True)."""
    vol = _vol(pair)
    ref = np.asarray(sgm_aggregate_pallas(vol, 8, 96, directions, interpret=True))
    before = dict(sgm_kernels.LAUNCHES)
    out = sgm_kernels.sgm_aggregate(torch.from_numpy(np.asarray(vol)), 8, 96, directions)
    assert sgm_kernels.LAUNCHES == before
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("min_disp,uniq,lr", [(1, 1, -1), (3, 5, -1), (1, 1, 1), (0, 10, 0)])
def test_wta_bit_equal(pair, min_disp, uniq, lr):
    agg = jsgm.sgm_aggregate(_vol(pair, min_disp), 8, 96, 8)
    ref = np.asarray(jsgm.wta_disparity(agg, min_disp, uniq, lr))
    out = tsgm.wta_disparity(torch.from_numpy(np.asarray(agg)), min_disp, uniq, lr).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("directions", [5, 8])
@pytest.mark.parametrize("min_disp,uniq", [(1, 1), (3, 5)])
def test_fused_plain_matches_pallas(pair, directions, min_disp, uniq):
    """The plain fused form == sgm_wta_fused_pallas(interpret=True), at the
    48x64x32 size of the JAX package's own fused-kernel test."""
    vol = _vol(pair, min_disp)
    ref = np.asarray(sgm_wta_fused_pallas(vol, 8, 96, directions, min_disp, uniq, interpret=True))
    out = tsgm.sgm_wta_fused_plain(torch.from_numpy(np.asarray(vol)), 8, 96, directions, min_disp, uniq)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_fused_wrapper_runs_plain_on_cpu(pair):
    vol = torch.from_numpy(np.asarray(_vol(pair)))
    before = dict(sgm_kernels.LAUNCHES)
    out = sgm_kernels.sgm_wta_fused(vol, 8, 96, 8, 1, 1)
    assert torch.equal(out, tsgm.sgm_wta_fused_plain(vol, 8, 96, 8, 1, 1))
    assert sgm_kernels.LAUNCHES == before


def test_sgm_disparity_matches_jax():
    rng = np.random.default_rng(3)
    base = (rng.random((40, 72)) * 255).astype(np.float32)
    match = np.roll(base, -5, axis=1)
    for directions in (8, 4):
        ref = np.asarray(jsgm.sgm_disparity(jnp.asarray(base), jnp.asarray(match), num_disp=24, min_disp=0,
                                            census_win=(5, 5), directions=directions))
        out = tsgm.sgm_disparity(torch.from_numpy(base), torch.from_numpy(match), num_disp=24, min_disp=0,
                                 census_win=(5, 5), directions=directions)
        np.testing.assert_array_equal(out.numpy(), ref)


def test_rejects_large_p2_and_bad_path_sets(pair):
    vol = torch.from_numpy(np.asarray(_vol(pair)))
    with pytest.raises(ValueError):
        tsgm.sgm_aggregate(vol, 8, 200, 8)
    with pytest.raises(ValueError):
        tsgm.sgm_wta_fused_plain(vol, 8, 96, 4, 1, 1)
