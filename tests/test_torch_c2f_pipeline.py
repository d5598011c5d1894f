"""Port parity of the dense stage's coarse-to-fine branch as a whole:
wass_tpu_torch DenseStereoPipeline (CPU, plain versions of K1-K4) against
the JAX package's DenseStereoPipeline on a conforming 256x192 scene
(num_disp 96, c2f_window 32, factor 4).

The JAX package gates c2f on a TPU (dense.py:_c2f_active) and compiles its
windowed kernels for it; here the gate is replaced by the shape gate alone
and the two windowed stages by the Pallas kernels in interpret mode.  Its
float stages run op by op, as in test_torch_dense.py.  The JAX package's
files are untouched."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wass_tpu.stereo import dense as jd
from wass_tpu.stereo.c2f import c2f_supported
from wass_tpu.stereo.sgm_pallas import census_cost_volume_pallas_windowed, sgm_wta_fused_pallas_windowed
from wass_tpu.testing import make_scene
from wass_tpu_torch import convert
from wass_tpu_torch.stereo import dense as td

H, W = 192, 256


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: the plain versions are
    thousands of small ops, and the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    kw = {"c2f_window": 32, **kw}
    return jd.DenseStereoConfig(num_disp=96, min_disp=1, c2f_factor=4, input_smooth_sigma=0.0, **kw)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def frame():
    sc = make_scene(seed=50, width=W, height=H, wave_amplitude=0.25)
    rig = sc.rig
    geom = jd.prepare_frame_geometry(rig.K0, rig.K1, rig.R, rig.T, (W, H))
    b_img, m_img = (sc.img0, sc.img1) if geom.base_is_cam0 else (sc.img1, sc.img0)
    b, m = jnp.asarray(b_img, jnp.float32), jnp.asarray(m_img, jnp.float32)
    br = jd.rectify_on_device(b, geom.H_base, (H, W))
    mr = jd.rectify_on_device(m, geom.H_match, (H, W))
    gp = jd.build_geom_pack(geom, (H, W))
    k1, _ = jax.random.split(jax.random.PRNGKey(0))
    picks = np.asarray(jax.random.randint(k1, (400, 3, 2), 0, jnp.array([W, H])))  # the JAX plane stage's draw
    return dict(scene=sc, b=b, m=m, br=br, mr=mr, gp=gp, tbr=_t(br), tmr=_t(mr), uv=_t(picks),
                tgp=convert.geom_pack_from_numpy({k: np.asarray(v) for k, v in gp.items()}))


def _port(frame, cfg, **kw):
    pipe = td.DenseStereoPipeline(convert.config_from_jax(cfg), **kw)
    return pipe, pipe(frame["tbr"], frame["tmr"], frame["tgp"], uv=frame["uv"])


@pytest.fixture(scope="module")
def full_range(frame):
    """The port's full-range result (c2f_window = 0)."""
    return _port(frame, _cfg(c2f_window=0))[1]


def _jax_c2f_on_cpu(monkeypatch):
    def active(cfg, shape):
        h, w = shape
        if cfg.dense_scale != 1.0:
            h, w = round(h * cfg.dense_scale), round(w * cfg.dense_scale)
        return cfg.c2f_window > 0 and c2f_supported(h, w, cfg.num_disp, cfg.c2f_window, cfg.c2f_factor,
                                                    cfg.directions, cfg.lr_max_diff)

    def cost_windowed(cb, cm, wstart, win_disp, num_disp, min_disp):
        return census_cost_volume_pallas_windowed(cb, cm, wstart, win_disp, num_disp, min_disp, interpret=True)

    def fused_windowed(cost, wstart, off_rows, P1, P2, directions, uniqueness_ratio):
        d = sgm_wta_fused_pallas_windowed(cost, wstart, P1, P2, directions, uniqueness_ratio, interpret=True)
        return jnp.where(d == 0.0, 0.0, d - 1.0 + off_rows[:, None].astype(jnp.float32))

    monkeypatch.setattr(jd, "_c2f_active", active)
    monkeypatch.setattr(jd, "_jit_cost_windowed", cost_windowed)
    monkeypatch.setattr(jd, "_jit_sgm_fused_windowed", fused_windowed)
    monkeypatch.setattr(jd, "_jit_triangulate", jd._jit_triangulate.__wrapped__)
    monkeypatch.setattr(jd, "_stage_plane", jd._stage_plane.__wrapped__)


def _rel(a, b):
    return np.linalg.norm(a - b, axis=-1) / np.linalg.norm(a, axis=-1)


def _check_frame_against_jax(frame, cfg, branch):
    """One frame of both packages: disparity bit-equal, points <= 1e-5
    relative where both are valid, plane <= 1e-4, n_points within 0.1%.
    Returns both results."""
    pj = jd.DenseStereoPipeline(cfg)
    rj = pj(frame["br"], frame["mr"], frame["b"], frame["m"], frame["gp"])
    pt, rt = _port(frame, cfg)
    if branch == "windowed":
        assert pj.last_c2f["fallback"] is False and pt.last_c2f["fallback"] is False
        assert abs(pt.last_c2f["coverage"] - pj.last_c2f["coverage"]) <= 1e-6
        assert abs(pt.last_c2f["offband"] - pj.last_c2f["offband"]) <= 1e-6
    else:
        assert pj.last_c2f is None and pt.last_c2f is None
    dj, dt = np.asarray(rj.disparity), rt.disparity.numpy()
    np.testing.assert_array_equal(dt, dj)
    both = np.asarray(rj.valid) & rt.valid.numpy()
    assert both.sum() > 0.5 * H * W
    assert _rel(np.asarray(rj.points)[both], rt.points.numpy()[both]).max() <= 1e-5
    assert bool(rt.plane_ok) and bool(rj.plane_ok)
    np.testing.assert_allclose(rt.plane.numpy(), np.asarray(rj.plane), rtol=0, atol=1e-4)
    assert abs(int(rt.n_points) - int(rj.n_points)) <= 0.001 * int(rj.n_points)
    return rj, rt


def test_windowed_frame_matches_jax(frame, full_range, monkeypatch):
    """Both take the windowed branch; windows' coverage within 1e-6,
    disparity bit-equal; points, mask and plane within the tolerances of
    test_torch_dense.py:test_slice_given_rectified_images."""
    _jax_c2f_on_cpu(monkeypatch)
    _rj, rt = _check_frame_against_jax(frame, _cfg(), "windowed")
    assert not np.array_equal(rt.disparity.numpy(), full_range.disparity.numpy())  # a different branch indeed


def _elevation_error(scene, res):
    """The trimmed-mean elevation error (testing.trimmed_elevation_error) of
    a frame's valid float points, against its own plane."""
    from wass_tpu_torch.testing import trimmed_elevation_error

    pts = np.asarray(res.points, np.float64)[np.asarray(res.valid)]
    return trimmed_elevation_error(scene, pts, np.asarray(res.plane, np.float64))


@pytest.mark.parametrize("branch", ["windowed", "full_range"])
def test_five_path_frame_matches_jax(frame, monkeypatch, branch):
    """The 5-path set (cv::StereoSGBM's), over the c2f windows and at full
    range, against the JAX frame as above; the two frames' elevation
    errors agree, so an error of the 5-path frame is the method's."""
    _jax_c2f_on_cpu(monkeypatch)
    cfg = _cfg(directions=5, **({"c2f_window": 0} if branch == "full_range" else {}))
    rj, rt = _check_frame_against_jax(frame, cfg, branch)
    ej, et = _elevation_error(frame["scene"], rj), _elevation_error(frame["scene"], rt)
    print(f"5-path {branch}: elevation error JAX {ej:.6f}, port {et:.6f}")
    assert abs(et - ej) <= 1e-3 * ej


def _assert_same_result(a, b):
    assert torch.equal(a.disparity, b.disparity)
    assert torch.equal(a.valid, b.valid)
    assert torch.equal(a.plane, b.plane)
    assert int(a.n_points) == int(b.n_points)


def test_forced_fallback_is_full_range(frame, full_range):
    """A frame whose guard trips (coverage can never reach 1.01) is the
    c2f_window = 0 frame exactly."""
    pipe, res = _port(frame, _cfg(c2f_min_coverage=1.01))
    assert pipe.last_c2f["fallback"] is True
    _assert_same_result(res, full_range)


def test_deferred_fallback_resolution(frame, full_range):
    """The deferred handshake (tests/test_c2f.py:237-289 on the port): the
    windowed pass runs with device-scalar diagnostics; healthy ones pass
    the result through, a tripped guard re-runs the frame at full range."""
    pipe, res = _port(frame, _cfg(), defer_c2f_fallback=True)
    info = pipe.last_c2f
    assert info["fallback"] is None and isinstance(info["coverage"], torch.Tensor)
    args = (frame["tbr"], frame["tmr"], frame["tgp"])
    res_ok, info_ok = pipe.resolve_fallback(res, info, *args, uv=frame["uv"])
    assert info_ok["fallback"] is False and res_ok is res
    assert pipe.resolve_fallback(res, info_ok, *args) == (res, info_ok)  # resolved once only
    bad = {"coverage": torch.tensor(0.2), "offband": torch.tensor(1e-5), "fallback": None}
    res_fb, info_fb = pipe.resolve_fallback(res, bad, *args, uv=frame["uv"])
    assert info_fb["fallback"] is True
    _assert_same_result(res_fb, full_range)
    assert dataclasses.replace(pipe.cfg, c2f_window=0) == pipe._full_pipe.cfg
