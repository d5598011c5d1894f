"""Port parity: the coarse-to-fine pieces (wass_tpu_torch/stereo/c2f.py) and
the plain versions of K2, K4 and K6 against wass_tpu/stereo/c2f.py and the
windowed Pallas kernels in interpret mode.  Everything here is integer or
follows the reference's float order, so every comparison is bit-exact
except coverage and offband (float32 ratios, within 1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wass_tpu.stereo import c2f as jc2f
from wass_tpu.stereo import cost as jcost
from wass_tpu.stereo.sgm_pallas import (
    census_cost_volume_pallas_windowed,
    sgm_aggregate_pallas_windowed,
    sgm_wta_fused_pallas_windowed,
)
from wass_tpu_torch.stereo import c2f as tc2f
from wass_tpu_torch.stereo import cost as tcost
from wass_tpu_torch.stereo import sgm as tsgm
from wass_tpu_torch.stereo import sgm_kernels


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: the plain versions are
    thousands of small ops, and the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape", [(64, 96), (192, 256)])
def test_downsample_pool_bit_equal(rng, shape):
    """At the c2f factor 4 (XLA's CPU order; see ROADMAP §3 for factor 2)."""
    img = (rng.random(shape) * 255).astype(np.float32)  # non-integer, like rectified pixels
    ref = np.asarray(jc2f.downsample_pool(jnp.asarray(img), 4))
    np.testing.assert_array_equal(tc2f.downsample_pool(_t(img), 4).numpy(), ref)


def _band(rng, Hc, Wc):
    return (8.0 + 0.5 * rng.standard_normal((Hc, Wc))).astype(np.float32)


def _window_maps():
    """(coarse map, num_disp, win_disp) cases after tests/test_c2f.py:134-196."""
    rng = np.random.default_rng(0)
    one_band = np.zeros((16, 8), np.float32)
    one_band[4:8] = 3.0
    band = _band(rng, 32, 40)
    junk = band.copy()
    junk[rng.integers(0, 32, 25), rng.integers(0, 40, 25)] = 14.9
    buoy = band.copy()
    buoy[10:14, 20:25] = 14.9
    ramp = (np.linspace(2.0, 30.0, 48)[:, None] + rng.random((48, 64))).astype(np.float32)
    ramp[rng.random(ramp.shape) < 0.2] = 0.0
    ramp[:, :3] = 0.0
    return {
        "one_band": (one_band, 64, 16),
        "all_invalid": (np.zeros((16, 8), np.float32), 64, 16),
        "scattered_junk": (junk, 64, 16),
        "buoy": (buoy, 64, 16),
        "ramp": (ramp, 160, 32),
    }


@pytest.mark.parametrize("case", list(_window_maps()))
def test_compute_row_windows(case):
    disp_c, num_disp, win = _window_maps()[case]
    ws_j, cov_j, off_j = jc2f.compute_row_windows(jnp.asarray(disp_c), 4, num_disp, 1, win)
    ws_t, cov_t, off_t = tc2f.compute_row_windows(_t(disp_c), 4, num_disp, 1, win)
    assert ws_t.dtype == torch.int32
    np.testing.assert_array_equal(ws_t.numpy(), np.asarray(ws_j))
    assert abs(float(cov_t) - float(cov_j)) <= 1e-6
    assert abs(float(off_t) - float(off_j)) <= 1e-6
    if case == "buoy":  # the off-band object trips the fallback on both sides
        from wass_tpu.stereo.dense import DenseStereoConfig, c2f_should_fallback
        from wass_tpu_torch.stereo.dense import c2f_should_fallback as t_should_fallback

        cfg = DenseStereoConfig(num_disp=num_disp, c2f_window=win)
        assert c2f_should_fallback(float(cov_j), float(off_j), cfg)
        assert t_should_fallback(float(cov_t), float(off_t), cfg)


def test_c2f_supported_and_coarse_num_disp():
    for H in (64, 96, 100, 192, 1536):
        for W in (128, 130, 2048):
            for num_disp, win in ((640, 128), (96, 32), (96, 96), (30, 16), (64, 18)):
                for factor in (2, 4):
                    for directions in (2, 4, 5, 8):
                        for lr in (-1, 0):
                            args = (H, W, num_disp, win, factor, directions, lr)
                            assert tc2f.c2f_supported(*args) == jc2f.c2f_supported(*args), args
    for num_disp in (16, 30, 96, 100, 256, 640, 641):
        for factor in (1, 2, 4, 8):
            assert tc2f.coarse_num_disp(num_disp, factor) == jc2f.coarse_num_disp(num_disp, factor)


def test_wta_disparity_windowed_bit_equal(rng):
    agg = rng.integers(0, 400, (16, 24, 12)).astype(np.int16)
    agg[:, :, 5] = 3  # clear winners on some rows
    agg[::3, :, 5] = 200
    off = np.repeat(np.array([2, 9], np.int32), 8)
    for uniq in (1, 10):
        ref = np.asarray(jc2f.wta_disparity_windowed(jnp.asarray(agg), jnp.asarray(off), uniq))
        out = tsgm.wta_disparity_windowed(_t(agg), _t(off), uniq).numpy()
        np.testing.assert_array_equal(out, ref)


@pytest.fixture(scope="module")
def census16():
    """Census words of a 16x64 random pair (5x5 window: one word)."""
    rng = np.random.default_rng(11)
    b = jnp.asarray(rng.uniform(0, 255, (16, 64)).astype(np.float32))
    m = jnp.asarray(rng.uniform(0, 255, (16, 64)).astype(np.float32))
    return jcost.census_transform(b, (5, 5)), jcost.census_transform(m, (5, 5))


def _words(census):
    """JAX uint32 census words as the port's int32 ones (same bits)."""
    return torch.from_numpy(np.asarray(census).view(np.int32))


@pytest.mark.parametrize("wstart,win,num_disp", [([1, 1], 16, 16), ([3, 9], 8, 24), ([30, 2], 12, 48)],
                         ids=["full_window", "shifted", "far_apart"])
def test_windowed_cost_plain_matches_pallas(census16, wstart, win, num_disp):
    """Plain K2 == census_cost_volume_pallas_windowed(interpret=True)."""
    cb, cm = census16
    ws = jnp.asarray(wstart, jnp.int32)
    ref = np.asarray(census_cost_volume_pallas_windowed(cb, cm, ws, win, num_disp, min_disp=1, interpret=True))
    out = tcost.census_cost_volume_windowed(_words(cb), _words(cm), _t(ws), win)
    np.testing.assert_array_equal(out.numpy(), ref)
    # The wrapper runs the plain version on CPU tensors and counts nothing.
    before = dict(sgm_kernels.LAUNCHES)
    assert torch.equal(sgm_kernels.census_cost_volume_windowed(_words(cb), _words(cm), _t(ws), win), out)
    assert sgm_kernels.LAUNCHES == before


# Window starts per 8-row tile: rising, flat, falling, and jumps of >= Dw
# (= 16) both ways, so every realignment case of the walks is met.
WSTARTS = [3, 9, 9, 5, 30, 12, 0, 0]


@pytest.fixture(scope="module")
def windowed_cost():
    rng = np.random.default_rng(5)
    return rng.integers(0, 60, (8 * len(WSTARTS), 24, 16)).astype(np.uint8)


@pytest.mark.parametrize("directions", [5, 8])
def test_fused_windowed_plain_matches_pallas(windowed_cost, directions):
    """Plain K4 == sgm_wta_fused_pallas_windowed(interpret=True) shifted
    by the window start as dense.py:_jit_sgm_fused_windowed does."""
    ws = jnp.asarray(WSTARTS, jnp.int32)
    cost = jnp.asarray(windowed_cost)
    d = sgm_wta_fused_pallas_windowed(cost, ws, 8, 96, directions, 1, interpret=True)
    off = jnp.repeat(ws, 8)
    ref = np.asarray(jnp.where(d == 0.0, 0.0, d - 1.0 + off[:, None].astype(jnp.float32)))
    out = sgm_kernels.sgm_wta_fused_windowed(_t(windowed_cost), _t(ws), 8, 96, directions, 1)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("directions", [2, 5, 8])
def test_windowed_aggregate_plain_matches_pallas(windowed_cost, directions):
    """Plain K6 == sgm_aggregate_pallas_windowed(interpret=True)."""
    ws = jnp.asarray(WSTARTS, jnp.int32)
    ref = np.asarray(sgm_aggregate_pallas_windowed(jnp.asarray(windowed_cost), ws, 8, 96, directions,
                                                   interpret=True))
    out = sgm_kernels.sgm_aggregate_windowed(_t(windowed_cost), _t(ws), 8, 96, directions)
    assert out.dtype == torch.int16
    np.testing.assert_array_equal(out.numpy(), ref)


def test_windowed_inputs_rejected(windowed_cost):
    cost = _t(windowed_cost)
    with pytest.raises(ValueError):
        tsgm.sgm_aggregate_windowed(cost, torch.zeros(3, dtype=torch.int32), 8, 96, 8)
    with pytest.raises(ValueError):
        tsgm.sgm_aggregate_windowed(cost, _t(np.array(WSTARTS, np.int32)), 8, 96, 4)
    with pytest.raises(ValueError):
        tsgm.sgm_wta_fused_windowed_plain(cost, _t(np.array(WSTARTS, np.int32)), 8, 96, 2)


def test_sgm_disparity_c2f_matches_jax(rng):
    """The whole c2f disparity on the row-disparity scene of
    tests/test_c2f.py:199-225, bit-equal to the JAX package's."""
    H, W = 64, 128
    drow = 6 + (np.arange(H) * 8) // H
    m = rng.uniform(0, 255, (H, W)).astype(np.float32)
    b = np.zeros_like(m)
    for y in range(H):
        d = int(drow[y])
        b[y, d:] = m[y, : W - d]
        b[y, :d] = m[y, :d][::-1]
    ref = np.asarray(jc2f.sgm_disparity_c2f(jnp.asarray(b), jnp.asarray(m), num_disp=32, min_disp=1, factor=4,
                                            win_disp=16, use_pallas=False, interpret=True))
    out = tc2f.sgm_disparity_c2f(_t(b), _t(m), num_disp=32, min_disp=1, factor=4, win_disp=16).numpy()
    np.testing.assert_array_equal(out, ref)
    assert (out > 0).mean() > 0.5
