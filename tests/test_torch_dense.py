"""Port parity: the dense stage (wass_tpu_torch/stereo/dense.py, plane.py)
against wass_tpu.stereo.dense on the TestBurnedGate scene (192x144,
D = 32), stage by stage and as a whole.

The JAX float stages (triangulation, plane fit) run op by op where floats
are compared: under jit XLA contracts multiply-adds into FMAs, and on this
scene that alone moves the JAX package's own plane by ~2e-4 against its
op-by-op run; the port follows the op-by-op float32 arithmetic.  The
integer stages (census, cost, SGM, WTA, labels) stay compiled.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wass_tpu.stereo import dense as jd
from wass_tpu.testing import make_scene
from wass_tpu_torch import convert
from wass_tpu_torch.stereo import dense as td
from wass_tpu_torch.stereo import plane as tplane


@pytest.fixture(scope="module")
def frame():
    sc = make_scene(seed=5, width=192, height=144, wave_amplitude=0.2)
    rig = sc.rig
    H, W = sc.img0.shape
    geom = jd.prepare_frame_geometry(rig.K0, rig.K1, rig.R, rig.T, (W, H))
    b_img, m_img = (sc.img0, sc.img1) if geom.base_is_cam0 else (sc.img1, sc.img0)
    b, m = jnp.asarray(b_img, jnp.float32), jnp.asarray(m_img, jnp.float32)
    br = jd.rectify_on_device(b, geom.H_base, (H, W))
    mr = jd.rectify_on_device(m, geom.H_match, (H, W))
    gp = jd.build_geom_pack(geom, (H, W))
    return dict(scene=sc, geom=geom, b=b, m=m, br=br, mr=mr, gp=gp,
                tgp=convert.geom_pack_from_numpy({k: np.asarray(v) for k, v in gp.items()}))


@pytest.fixture
def eager_float_stages(monkeypatch):
    """JAX DenseStereoPipeline with its triangulation and plane stages op by op."""
    monkeypatch.setattr(jd, "_jit_triangulate", jd._jit_triangulate.__wrapped__)
    monkeypatch.setattr(jd, "_stage_plane", jd._stage_plane.__wrapped__)


def _cfg(**kw):
    return jd.DenseStereoConfig(num_disp=32, min_disp=1, **kw)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_picks(cfg, H, W):
    """The RANSAC pixel picks the JAX plane stage draws (plane.py:47-48)."""
    k1, _ = jax.random.split(jax.random.PRNGKey(cfg.random_seed))
    return np.asarray(jax.random.randint(k1, (cfg.plane_ransac_rounds, 3, 2), 0, jnp.array([W, H])))


def _rel(a, b):
    return np.linalg.norm(a - b, axis=-1) / np.linalg.norm(a, axis=-1)


def test_disparity_postprocess_bit_equal(rng):
    d = (rng.random((40, 56)) * 30 + 1).astype(np.float32)
    d[rng.random(d.shape) < 0.3] = 0
    for cfg in (_cfg(), _cfg(median_filter_wsize=3, disp_dilate_steps=2)):
        ref = np.asarray(jd.disparity_postprocess(jnp.asarray(d), cfg))
        out = td.disparity_postprocess(_t(d), convert.config_from_jax(cfg)).numpy()
        np.testing.assert_array_equal(out, ref)


def test_burned_match_mask(rng):
    disp = (rng.random((16, 64)) * 20).astype(np.float32)
    disp[0, :8] = [0.5, 1.5, 2.5, 3.5, 2.4999, 6.0, 6.5, 7.5]  # round half to even
    bm = rng.random((16, 64)) > 0.7
    bm[:, -4:] = True  # right-edge saturation must not wrap to the left edge
    ref = np.asarray(jd.burned_match_mask(jnp.asarray(disp), jnp.asarray(bm), 1, 16))
    np.testing.assert_array_equal(td.burned_match_mask(_t(disp), _t(bm), 1, 16).numpy(), ref)


def test_triangulate_dense(frame):
    """Given identical disparity and geometry pack: points <= 1e-5 relative
    where both are valid, masks and failure codes equal on >= 99.99%."""
    cfg = _cfg()
    disp = jd._stage_disparity(frame["br"], frame["mr"], cfg)
    with jax.disable_jit():
        pj, vj, rj = jd.triangulate_dense(disp, frame["gp"], frame["br"], frame["mr"], cfg)
    pt, vt, rt = td.triangulate_dense(_t(disp), frame["tgp"], _t(frame["br"]), _t(frame["mr"]),
                                      convert.config_from_jax(cfg))
    pj, vj, rj = np.asarray(pj), np.asarray(vj), np.asarray(rj)
    both = vj & vt.numpy()
    assert both.sum() > 10000
    assert _rel(pj[both], pt.numpy()[both]).max() <= 1e-5
    assert (vj == vt.numpy()).mean() >= 0.9999
    assert (rj == rt.numpy()).mean() >= 0.9999


def _points(frame, cfg):
    """JAX-triangulated points and mask: shared input data for both packages."""
    disp = jd._stage_disparity(frame["br"], frame["mr"], cfg)
    pts, valid, _ = jd._jit_triangulate(disp, frame["gp"], frame["br"], frame["mr"], cfg)
    return pts, valid


def test_zgap_threshold_and_keep(frame):
    cfg = _cfg()
    pts, valid = _points(frame, cfg)
    keep_j, zgap_j = jax.jit(jd.outlier_removal, static_argnames="cfg")(pts, valid, cfg)
    keep_t, zgap_t = td.outlier_removal(_t(pts), _t(valid), convert.config_from_jax(cfg))
    assert abs(float(zgap_t) - float(zgap_j)) <= 1e-6 * abs(float(zgap_j))
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))


def test_plane_with_injected_picks(frame):
    cfg = _cfg()
    H, W = frame["br"].shape
    pts, valid = _points(frame, cfg)
    valid = jd._jit_outlier(pts, valid, cfg)
    with jax.disable_jit():
        plane_j, ok_j, vf_j = jd._stage_plane(pts, valid, cfg)
    uv = _t(_jax_picks(cfg, H, W))
    plane_t, ok_t, vf_t = td.plane_stage(_t(pts), _t(valid), convert.config_from_jax(cfg), uv)
    assert bool(ok_t) == bool(ok_j)
    np.testing.assert_allclose(plane_t.numpy(), np.asarray(plane_j), rtol=0, atol=1e-5)
    assert (vf_t.numpy() == np.asarray(vf_j)).mean() >= 0.9999
    # The default draw is seeded: the same picks on every call.
    assert torch.equal(tplane.draw_pixels(400, H, W, 0), tplane.draw_pixels(400, H, W, 0))


def test_export_payload_identical(rng):
    """Given JAX's points, valid mask and plane: the u16 payload and its
    float header are byte-identical."""
    H, W = 40, 56
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    z = 10.0 + 0.01 * xx + 0.02 * yy + 0.2 * np.sin(xx / 5.0)
    z[yy > 30] += 5.0
    pts = np.stack([(xx - W / 2) * z / 100, (yy - H / 2) * z / 100, z], -1).astype(np.float32)
    valid = rng.random((H, W)) > 0.25
    plane = np.array([0.01, -0.02, 0.9, -9.5])
    plane[:3] /= np.linalg.norm(plane[:3])
    plane = plane.astype(np.float32)
    q_j, mins_j, scales_j = jd._stage_export(jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(plane))
    q_t, mins_t, scales_t = td.export_u16(_t(pts), _t(valid), _t(plane))
    n = int(valid.sum())
    assert q_t.numpy().astype(np.uint16).tobytes() == np.asarray(q_j)[:n].tobytes()
    assert mins_t.numpy().astype(np.float64).tobytes() == np.asarray(mins_j, np.float64).tobytes()
    assert scales_t.numpy().astype(np.float64).tobytes() == np.asarray(scales_j, np.float64).tobytes()


@pytest.mark.parametrize("sigma", [0.0, -1.0], ids=["sigma0", "auto"])
def test_slice_given_rectified_images(frame, eager_float_stages, sigma):
    """Port DenseStereoPipeline (CPU, plain versions) vs the JAX one on JAX's
    rectified images: disparity bit-equal at sigma 0, equal on >= 99.9% at
    AUTO; points, masks and plane as in the stage tests."""
    cfg = _cfg(input_smooth_sigma=sigma)
    H, W = frame["br"].shape
    rj = jd.DenseStereoPipeline(cfg)(frame["br"], frame["mr"], frame["b"], frame["m"], frame["gp"])
    rt = td.DenseStereoPipeline(convert.config_from_jax(cfg))(
        _t(frame["br"]), _t(frame["mr"]), frame["tgp"], uv=_t(_jax_picks(cfg, H, W))
    )
    dj, dt = np.asarray(rj.disparity), rt.disparity.numpy()
    if sigma == 0.0:
        np.testing.assert_array_equal(dt, dj)
    assert (dt == dj).mean() >= 0.999
    both = np.asarray(rj.valid) & rt.valid.numpy()
    assert _rel(np.asarray(rj.points)[both], rt.points.numpy()[both]).max() <= 1e-5
    assert bool(rt.plane_ok) and bool(rj.plane_ok)
    np.testing.assert_allclose(rt.plane.numpy(), np.asarray(rj.plane), rtol=0, atol=1e-4)
    assert abs(int(rt.n_points) - int(rj.n_points)) <= 0.001 * int(rj.n_points)


def test_slice_from_raw_images(frame, eager_float_stages):
    """From the raw pair (each package rectifies and resolves AUTO itself,
    as dense_stereo_frame does): disparity equal on >= 99.9%, plane <= 1e-4,
    n_points within 0.1% (the rectifications differ by float32 rounding)."""
    from wass_tpu.prepare.degradation import resolve_smooth_sigma

    sc = frame["scene"]
    rig = sc.rig
    cfg = _cfg()
    H, W = sc.img0.shape
    jcfg = dataclasses.replace(cfg, input_smooth_sigma=resolve_smooth_sigma(-1.0, sc.img0, "dense"))
    rj = jd.DenseStereoPipeline(jcfg)(frame["br"], frame["mr"], frame["b"], frame["m"], frame["gp"])
    rt, geom = td.dense_stereo_frame(sc.img0, sc.img1, rig.K0, rig.K1, rig.R, rig.T,
                                     convert.config_from_jax(cfg), uv=_t(_jax_picks(cfg, H, W)))
    assert geom.base_is_cam0 == frame["geom"].base_is_cam0
    assert (rt.disparity.numpy() == np.asarray(rj.disparity)).mean() >= 0.999
    np.testing.assert_allclose(rt.plane.numpy(), np.asarray(rj.plane), rtol=0, atol=1e-4)
    assert abs(int(rt.n_points) - int(rj.n_points)) <= 0.001 * int(rj.n_points)
    assert int(rt.n_points) > 1000
