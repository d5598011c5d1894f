"""Port parity of the H2 SGM pieces (the JAX package's _USE_H2 path: the
horizontal pair in image layout, folded into the first row walk).

The plain versions in wass_tpu_torch/stereo/sgm.py against the Pallas
functions of wass_tpu/stereo/sgm_pallas.py in interpret mode, the four
public wrappers of wass_tpu_torch/stereo/sgm_kernels.py on CPU tensors
with _USE_H2 set against the JAX entry points with theirs set, and a whole
frame with H2 on against H2 off.  The JAX functions are called eagerly:
dense.py's jitted wrappers would keep the flag of their first trace.  All
comparisons are bit-exact (integer sums, the IEEE WTA).

An interpret-mode Pallas call takes 1-2 s here, so each Pallas piece runs
once per module for given inputs: the JAX entry points reuse the results
of the piece tests before them."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wass_tpu.stereo import sgm_pallas as sp
from wass_tpu.testing import make_scene
from wass_tpu_torch.stereo import dense as td
from wass_tpu_torch.stereo import sgm as tsgm
from wass_tpu_torch.stereo import sgm_kernels

P1, P2 = 8, 96
# Window starts per 8-row tile: flat, rising, falling, and jumps of >= Dw
# (= 16) both ways.
WSTARTS = [3, 3, 9, 5, 30, 2]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: the plain versions are
    thousands of small ops, and the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# The Pallas pieces that the JAX entry points compose.
_PIECES = ("_run_pair", "_run_pair_img", "_run_tri_dir", "_run_tri_dir_windowed", "_run_tri_dir_partial_h2",
           "_run_tri_dir_wta_h2", "_run_tri_dir_wta", "_run_tri_dir_partial_windowed_h2",
           "_run_tri_dir_wta_windowed_h2", "_run_tri_dir_wta_windowed")


def _once(fn):
    """fn with its results kept, keyed by its bound arguments (arrays by
    dtype, shape and bytes)."""
    sig, results = inspect.signature(fn), {}

    def call(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        key = tuple((np.asarray(v).dtype.str, np.shape(v), np.asarray(v).tobytes())
                    if isinstance(v, (jax.Array, np.ndarray)) else v for v in bound.arguments.values())
        if key not in results:
            results[key] = fn(*args, **kwargs)
        return results[key]

    return call


@pytest.fixture(scope="module", autouse=True)
def _pallas_once():
    with pytest.MonkeyPatch.context() as mp:
        for name in _PIECES:
            mp.setattr(sp, name, _once(getattr(sp, name)))
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def cost():
    return np.random.default_rng(21).integers(0, 64, (16, 24, 16)).astype(np.uint8)


@pytest.fixture(scope="module")
def wcost():
    return np.random.default_rng(22).integers(0, 64, (8 * len(WSTARTS), 24, 16)).astype(np.uint8)


def _pair(c):
    """JAX hf, hb in interpret mode, and the port's plain ones, of cost c."""
    hf, hb = sp._run_pair_img(jnp.asarray(c), P1, P2, interpret=True)
    return hf, hb, tsgm.run_pair_img_plain(_t(c), P1, P2)


@pytest.fixture(scope="module")
def pair(cost):
    return _pair(cost)


@pytest.fixture(scope="module")
def wpair(wcost):
    return _pair(wcost)


@pytest.fixture(scope="module")
def partials(cost, pair):
    """JAX _run_tri_dir_partial_h2 of each walk."""
    hf, hb, _ = pair
    return {rev: sp._run_tri_dir_partial_h2(jnp.asarray(cost), hf, hb, P1, P2, rev, interpret=True)
            for rev in (False, True)}


@pytest.fixture(scope="module")
def wpartials(wcost, wpair):
    """JAX _run_tri_dir_partial_windowed_h2 of each walk."""
    hf, hb, _ = wpair
    ws = jnp.asarray(WSTARTS, jnp.int32)
    return {rev: sp._run_tri_dir_partial_windowed_h2(jnp.asarray(wcost), hf, hb, ws, 8, P1, P2, rev, interpret=True)
            for rev in (False, True)}


def _shift(d, ws):
    """JAX window-local disparity -> true units (dense.py's order)."""
    off = jnp.repeat(jnp.asarray(ws, jnp.int32), 8)
    return np.asarray(jnp.where(d == 0.0, 0.0, d - 1.0 + off[:, None].astype(jnp.float32)))


def test_pair_img(pair):
    hf, hb, (thf, thb) = pair
    assert thf.dtype == torch.uint8 and thb.dtype == torch.uint8
    np.testing.assert_array_equal(thf.numpy(), np.asarray(hf))
    np.testing.assert_array_equal(thb.numpy(), np.asarray(hb))


@pytest.mark.parametrize("reverse", [False, True])
def test_tri_dir_partial_h2(cost, pair, partials, reverse):
    _, _, (thf, thb) = pair
    ref = np.asarray(partials[reverse])
    out = tsgm.run_tri_dir_partial_h2_plain(_t(cost), thf, thb, P1, P2, reverse)
    assert out.dtype == torch.int16
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("min_disp,uniq", [(0, 1), (0, 5), (3, 1), (3, 5)])
def test_tri_dir_wta_h2(cost, pair, reverse, min_disp, uniq):
    hf, hb, (thf, thb) = pair
    ref = np.asarray(sp._run_tri_dir_wta_h2(jnp.asarray(cost), hf, hb, P1, P2, reverse, min_disp, uniq,
                                            interpret=True))
    out = tsgm.run_tri_dir_wta_h2_plain(_t(cost), thf, thb, P1, P2, reverse, min_disp, uniq)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("reverse", [False, True])
def test_tri_dir_wta_and_walk_add(cost, partials, reverse):
    """The non-H2 single walks the H2 compositions take: _run_tri_dir_wta
    over the H2 partial of the other walk (the 8-path final walk), and
    _run_tri_dir as walk_add into zeros."""
    c = jnp.asarray(cost)
    partial = partials[not reverse]
    ref = np.asarray(sp._run_tri_dir_wta(c, partial, P1, P2, reverse, 3, 1, interpret=True))
    out = tsgm.run_tri_dir_wta_plain(_t(cost), _t(partial), P1, P2, reverse, 3, 1)
    np.testing.assert_array_equal(out.numpy(), ref)
    ref = np.asarray(sp._run_tri_dir(c, P1, P2, reverse, interpret=True))
    walk = "bwd" if reverse else "fwd"
    out = tsgm.walk_add(_t(cost), torch.zeros(cost.shape, dtype=torch.int16), walk, P1, P2)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("reverse", [False, True])
def test_tri_dir_partial_windowed_h2(wcost, wpair, wpartials, reverse):
    _, _, (thf, thb) = wpair
    out = tsgm.run_tri_dir_partial_windowed_h2_plain(_t(wcost), thf, thb, torch.tensor(WSTARTS, dtype=torch.int32),
                                                     P1, P2, reverse)
    np.testing.assert_array_equal(out.numpy(), np.asarray(wpartials[reverse]))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("uniq", [1, 5])
def test_tri_dir_wta_windowed_h2(wcost, wpair, reverse, uniq):
    """Window-local JAX disparity shifted to true units, as the port gives it."""
    hf, hb, (thf, thb) = wpair
    ws = jnp.asarray(WSTARTS, jnp.int32)
    d = sp._run_tri_dir_wta_windowed_h2(jnp.asarray(wcost), hf, hb, ws, 8, P1, P2, reverse, uniq, interpret=True)
    out = tsgm.run_tri_dir_wta_windowed_h2_plain(_t(wcost), thf, thb, _t(ws), P1, P2, reverse, uniq)
    np.testing.assert_array_equal(out.numpy(), _shift(d, WSTARTS))


@pytest.mark.parametrize("reverse", [False, True])
def test_tri_dir_wta_windowed_and_walk_add(wcost, wpartials, reverse):
    c, ws = jnp.asarray(wcost), jnp.asarray(WSTARTS, jnp.int32)
    partial = wpartials[not reverse]
    d = sp._run_tri_dir_wta_windowed(c, partial, ws, 8, P1, P2, reverse, 1, interpret=True)
    out = tsgm.run_tri_dir_wta_windowed_plain(_t(wcost), _t(partial), _t(ws), P1, P2, reverse, 1)
    np.testing.assert_array_equal(out.numpy(), _shift(d, WSTARTS))
    ref = np.asarray(sp._run_tri_dir_windowed(c, ws, 8, P1, P2, reverse, interpret=True))
    walk = "bwd" if reverse else "fwd"
    out = tsgm.walk_add(_t(wcost), torch.zeros(wcost.shape, dtype=torch.int16), walk, P1, P2, _t(ws))
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.fixture
def h2(monkeypatch):
    """_USE_H2 on in both packages for one test (read at call time)."""
    monkeypatch.setattr(sp, "_USE_H2", True)
    monkeypatch.setattr(sgm_kernels, "_USE_H2", True)


@pytest.mark.parametrize("directions", [5, 8])
def test_fused_wrappers_h2(h2, monkeypatch, cost, wcost, directions):
    ref = np.asarray(sp.sgm_wta_fused_pallas(jnp.asarray(cost), P1, P2, directions, 3, 1, interpret=True))
    before = dict(sgm_kernels.LAUNCHES)
    out = sgm_kernels.sgm_wta_fused(_t(cost), P1, P2, directions, 3, 1)
    np.testing.assert_array_equal(out.numpy(), ref)
    ws = jnp.asarray(WSTARTS, jnp.int32)
    d = sp.sgm_wta_fused_pallas_windowed(jnp.asarray(wcost), ws, P1, P2, directions, 1, interpret=True)
    out = sgm_kernels.sgm_wta_fused_windowed(_t(wcost), _t(ws), P1, P2, directions, 1)
    np.testing.assert_array_equal(out.numpy(), _shift(d, WSTARTS))
    assert sgm_kernels.LAUNCHES == before  # CPU tensors: plain versions, no launch
    # ... and H2 is the same function as the default path.
    monkeypatch.setattr(sgm_kernels, "_USE_H2", False)
    assert torch.equal(out, sgm_kernels.sgm_wta_fused_windowed(_t(wcost), _t(ws), P1, P2, directions, 1))


@pytest.mark.parametrize("directions", [2, 4, 5, 8])
def test_aggregate_wrapper_h2(h2, cost, directions):
    ref = np.asarray(sp.sgm_aggregate_pallas(jnp.asarray(cost), P1, P2, directions, interpret=True))
    out = sgm_kernels.sgm_aggregate(_t(cost), P1, P2, directions)
    assert out.dtype == torch.int16
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("directions", [2, 5, 8])
def test_aggregate_windowed_wrapper_h2(h2, wcost, directions):
    ws = jnp.asarray(WSTARTS, jnp.int32)
    ref = np.asarray(sp.sgm_aggregate_pallas_windowed(jnp.asarray(wcost), ws, P1, P2, directions, interpret=True))
    out = sgm_kernels.sgm_aggregate_windowed(_t(wcost), _t(ws), P1, P2, directions)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_h2_rejects_bad_path_sets(h2, cost):
    with pytest.raises(ValueError):
        sgm_kernels.sgm_wta_fused(_t(cost), P1, P2, 4, 1, 1)
    with pytest.raises(ValueError):
        sgm_kernels.sgm_aggregate_windowed(_t(cost), torch.zeros(2, dtype=torch.int32), P1, P2, 4)
    with pytest.raises(ValueError):
        sgm_kernels.sgm_aggregate(_t(cost), P1, 200, 8)


FH, FW = 192, 256


@pytest.fixture(scope="module")
def frame():
    """A rectified 256x192 pair of the c2f parity test's scene."""
    sc = make_scene(seed=50, width=FW, height=FH, wave_amplitude=0.25)
    rig = sc.rig
    geom = td.prepare_frame_geometry(rig.K0, rig.K1, rig.R, rig.T, (FW, FH))
    b_img, m_img = (sc.img0, sc.img1) if geom.base_is_cam0 else (sc.img1, sc.img0)
    br = td.rectify_on_device(torch.as_tensor(b_img, dtype=torch.float32), geom.H_base, (FH, FW))
    mr = td.rectify_on_device(torch.as_tensor(m_img, dtype=torch.float32), geom.H_match, (FH, FW))
    return br, mr, td.build_geom_pack(geom, (FH, FW), "cpu")


@pytest.mark.parametrize("override,windowed", [
    ({}, True),                                  # c2f, 8 paths
    ({"directions": 5}, True),                   # c2f, 5 paths (8-path coarse pass)
    ({"directions": 5, "c2f_window": 0}, None),  # full range, 5 paths
    ({"lr_max_diff": 1}, None),                  # the left-right check (unfused aggregate)
], ids=["c2f_8", "c2f_5", "full_5", "lr_check"])
def test_frame_h2_equals_default(frame, monkeypatch, override, windowed):
    """One frame through DenseStereoPipeline with H2 on gives the points
    and plane of the same frame with H2 off."""
    cfg = td.DenseStereoConfig(**{"num_disp": 96, "c2f_window": 32, "input_smooth_sigma": 0.0, **override})
    pairs = []  # the shapes sgm_pair_img ran at: H2 did run
    pair_img = sgm_kernels.sgm_pair_img
    monkeypatch.setattr(sgm_kernels, "sgm_pair_img", lambda c, *a: pairs.append(tuple(c.shape)) or pair_img(c, *a))
    results = []
    for flag in (False, True):
        monkeypatch.setattr(sgm_kernels, "_USE_H2", flag)
        pipe = td.DenseStereoPipeline(cfg)
        results.append(pipe(*frame))
        assert len(pairs) == (2 if windowed else 1) * flag
        if windowed is None:
            assert pipe.last_c2f is None
        else:
            assert pipe.last_c2f["fallback"] is False
    off, on = results
    assert bool(off.plane_ok) and int(off.n_points) > 0.3 * FH * FW
    assert torch.equal(on.disparity, off.disparity)
    assert torch.equal(on.valid, off.valid)
    assert torch.equal(on.points, off.points)
    assert torch.equal(on.plane, off.plane)
