"""The optical-flow path of the port (stereo/flow.py, stereo/flow_kernels.py's
plain versions, io/ply.py, utils/render.py:render_flow, the flow options)
against the JAX package's (wass_tpu/stereo/flow.py and friends), on inputs
made from a seed with numpy.

Tolerances and why:
- morphology, the image gradients, the gates and the renders are exact:
  the same float ops in the same order (the gates' norm is XLA's chain of
  fused multiply-adds, fma32);
- the homography products and the bilinear samples of the coarse flow
  are written out elementwise (XLA's CPU dot sums in its own order), so a
  pixel whose bilinear mask sample sits at the 0.999 gate may flip; the
  flows agree within 1e-4 px where both are valid;
- the box sums and the solver's average are shifted adds in one order,
  XLA's convolution sums in another (not reproduced), and the jitted JAX
  solver contracts multiply-adds: one sweep agrees within 1e-4 px; over
  several warps a pixel whose warp crosses the one-pixel border (its data
  weight jumps from 0) or a bilinear cell edge can move further, so the
  multi-warp runs hold the median within 1e-5 px and all but 1% of the
  pixels within 1e-3 px.
"""

import dataclasses

import cv2
import imageio.v3 as iio
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wass_tpu.io import ply as jply
from wass_tpu.ops.sampling import bilinear_sample as jbilinear
from wass_tpu.stereo import dense as jd
from wass_tpu.stereo import flow as jf
from wass_tpu.testing import make_scene
from wass_tpu.utils.render import render_flow as jax_render_flow
from wass_tpu_torch import convert
from wass_tpu_torch.io import ply as tply
from wass_tpu_torch.stereo import dense as td
from wass_tpu_torch.stereo import flow as tf
from wass_tpu_torch.stereo import flow_kernels as fk
from wass_tpu_torch.utils import render as trender
from torch_registries import reset_registries  # noqa: F401  (autouse)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """Two intra-op threads while this module runs (the test workers share
    the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _texture(rng, h, w, sigma=2.0):
    return cv2.GaussianBlur(rng.random((h, w)).astype(np.float32), (0, 0), sigma) * 255.0


def _translated_pair(rng, h, w, dx=1.3, dy=-0.8):
    """(I0, I1) with I0(p) = I1(p + (dx, dy))."""
    tex = _texture(rng, h, w)
    xx = np.arange(w, dtype=np.float32)[None].repeat(h, 0)
    yy = np.arange(h, dtype=np.float32)[:, None].repeat(w, 1)
    I0 = np.asarray(jbilinear(jnp.asarray(tex), jnp.asarray(xx + dx), jnp.asarray(yy + dy), fill=0.0))
    return I0, tex


def _multiwarp_close(t, j):
    d = np.abs(t - j).max(-1)
    assert np.median(d) < 1e-5, np.median(d)
    assert np.mean(d > 1e-3) < 0.01, np.mean(d > 1e-3)


@pytest.mark.parametrize("steps", [1, 2])
def test_morphology_exact(rng, steps):
    m = (rng.random((23, 31)) > 0.6).astype(np.float32)
    m[0, :] = 1.0
    m[:, -1] = 1.0
    jdil = np.asarray(jf.binary_dilate(jnp.asarray(m), steps))
    tdil = tf.binary_dilate(_t(m), steps).numpy()
    assert np.array_equal(jdil, tdil)
    assert np.array_equal(np.asarray(jf.binary_erode(jnp.asarray(jdil), steps)), tf.binary_erode(_t(tdil), steps).numpy())
    for dy, dx in ((-1, 1), (1, -1), (0, 1), (1, 0)):
        assert np.array_equal(np.asarray(jf._shift2(jnp.asarray(m), dy, dx, 0.5)), tf._shift2(_t(m), dy, dx, 0.5).numpy())


def test_image_grads_exact_and_wrapping(rng):
    img = _texture(rng, 20, 33)
    for j, t in zip(jf._image_grads(jnp.asarray(img)), tf._image_grads(_t(img))):
        assert np.array_equal(np.asarray(j), t.numpy())
    gx = tf._image_grads(_t(img))[0].numpy()
    assert gx[5, 0] == np.float32((img[5, 1] - img[5, -1]) * 0.5)  # wraps, not zero-padded


def _homographies(rng):
    Hb = np.eye(3) + rng.normal(size=(3, 3)) * np.array([[1e-2, 1e-2, 1.0], [1e-2, 1e-2, 1.0], [1e-5, 1e-5, 0]])
    Hm = np.eye(3) + rng.normal(size=(3, 3)) * np.array([[1e-2, 1e-2, 1.0], [1e-2, 1e-2, 1.0], [1e-5, 1e-5, 0]])
    return Hb.astype(np.float32), Hm.astype(np.float32)


def test_coarse_flow_matches_jax(rng):
    h, w = 48, 72
    disp = (rng.random((h, w)) * 8 + 0.5).astype(np.float32)
    valid_rect = rng.random((h, w)) > 0.1
    Hb, Hm = _homographies(rng)
    jflow, jvalid = jf.coarse_flow_from_disparity(jnp.asarray(disp), jnp.asarray(Hb), jnp.asarray(Hm), (h, w), 1.0,
                                                  valid_rect=jnp.asarray(valid_rect))
    tflow, tvalid = tf.coarse_flow_from_disparity(_t(disp), Hb, Hm, (h, w), 1.0, valid_rect=_t(valid_rect))
    jvalid, tvalid = np.asarray(jvalid), tvalid.numpy()
    assert jvalid.sum() > 0.3 * h * w
    assert (jvalid != tvalid).sum() <= 2  # a bilinear mask sample at the 0.999 gate
    both = jvalid & tvalid
    np.testing.assert_allclose(tflow.numpy()[both], np.asarray(jflow)[both], rtol=0, atol=1e-4)
    assert not tflow.numpy()[~tvalid].any()


def test_coarse_flow_identity_is_pure_disparity():
    h, w, d = 40, 64, 5.0
    flow, valid = tf.coarse_flow_from_disparity(torch.full((h, w), d), np.eye(3), np.eye(3), (h, w), 1.0)
    v = valid.numpy()
    assert v[5:-5, 8:-8].all()
    np.testing.assert_allclose(flow.numpy()[v][:, 0], -d, atol=1e-4)
    np.testing.assert_allclose(flow.numpy()[v][:, 1], 0.0, atol=1e-4)


def test_idw_fill_matches_jax(rng):
    h, w = 40, 52
    flow = (rng.normal(size=(h, w, 2)) * 3).astype(np.float32)
    valid = rng.random((h, w)) > 0.85
    valid[:12, :12] = False  # a hole wider than one pass
    j = np.asarray(jf.idw_fill(jnp.asarray(flow), jnp.asarray(valid), reps=24))
    t = tf.idw_fill(_t(flow), _t(valid), reps=24).numpy()
    assert np.array_equal(t[valid], flow[valid])
    np.testing.assert_allclose(t, j, rtol=0, atol=2e-5)


def test_linearisation_matches_jax(rng):
    """One warp and linearisation (outer_body) against the JAX ops."""
    h, w = 37, 53
    I0, I1 = _translated_pair(rng, h, w)
    u, v = (rng.normal(size=(h, w)) * 2).astype(np.float32), (rng.normal(size=(h, w)) * 2).astype(np.float32)
    u[0, :3] = [-5.0, 60.0, np.nan]  # warps that leave the image
    g1x, g1y = jf._image_grads(jnp.asarray(I1))
    xx = jnp.arange(w, dtype=jnp.float32)[None, :].repeat(h, 0)
    yy = jnp.arange(h, dtype=jnp.float32)[:, None].repeat(w, 1)
    px, py = xx + u, yy + v
    It = jbilinear(jnp.asarray(I1), px, py, fill=0.0) - I0
    Ix = jbilinear(g1x, px, py, fill=0.0)
    Iy = jbilinear(g1y, px, py, fill=0.0)
    inb = ((px >= 1) & (px <= w - 2) & (py >= 1) & (py <= h - 2)).astype(jnp.float32)
    want = (It, Ix, Iy, inb / jnp.sqrt(It * It + 1e-3))
    tg = tf._image_grads(_t(I1))
    got = fk.flow_linearize(_t(I0), _t(I1), tg[0], tg[1], _t(u), _t(v))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-5)


def test_jacobi_sweep_matches_jax(rng):
    """One linearisation and one sweep: the JAX solver with outer = inner = 1."""
    I0, I1 = _translated_pair(rng, 31, 45)
    init = (rng.normal(size=(31, 45, 2)) * 0.5).astype(np.float32)
    j = np.asarray(jf.variational_refine(jnp.asarray(I0), jnp.asarray(I1), jnp.asarray(init), 30.0, 100.0, outer=1,
                                         inner=1))
    t = tf.variational_refine(_t(I0), _t(I1), _t(init), 30.0, 100.0, 1, 1).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-4)


def test_smoothness_ratio_is_float32():
    assert tf.smoothness_ratio(90.0, 100.0) == float(np.float32(90.0) / np.float32(100.0))
    assert tf.smoothness_ratio(90.0, 100.0) != 0.9
    assert tf.smoothness_ratio(1.0, 0.0) == float(np.float32(1.0) / np.float32(1e-6))


def test_variational_refine_one_warp_matches_jax(rng):
    """96x64, one warp of 25 sweeps."""
    I0, I1 = _translated_pair(rng, 64, 96)
    init = (rng.normal(size=(64, 96, 2)) * 0.5).astype(np.float32)
    j = np.asarray(jf.variational_refine(jnp.asarray(I0), jnp.asarray(I1), jnp.asarray(init), 30.0, 100.0, outer=1,
                                         inner=25))
    t = tf.variational_refine(_t(I0), _t(I1), _t(init), 30.0, 100.0, 1, 25).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-4)


def test_variational_refine_recovers_translation(rng):
    """The JAX test's property on the port: 12 warps recover a known shift."""
    I0, I1 = _translated_pair(rng, 64, 96)
    out = tf.variational_refine(_t(I0), _t(I1), torch.zeros((64, 96, 2)), 30.0, 100.0, 12, 25).numpy()[8:-8, 8:-8]
    assert np.median(np.hypot(out[..., 0] - 1.3, out[..., 1] + 0.8)) < 0.25


def test_variational_refine_fullres_matches_jax(rng):
    """256x192 with the JAX test's fullres_iterations 100 (4 warps of 25)."""
    I0, I1 = _translated_pair(rng, 192, 256, 2.2, 0.4)
    init = np.zeros((192, 256, 2), np.float32)
    init[..., 0] = 2.0
    j = np.asarray(jf.variational_refine(jnp.asarray(I0), jnp.asarray(I1), jnp.asarray(init), 300.0, 100.0, outer=4,
                                         inner=25))
    t = tf.variational_refine(_t(I0), _t(I1), _t(init), 300.0, 100.0, 4, 25).numpy()
    _multiwarp_close(t, j)


def test_two_scale_matches_jax(rng):
    I0, I1 = _translated_pair(rng, 64, 96, 1.5, 0.5)
    init = (rng.normal(size=(64, 96, 2)) * 0.3).astype(np.float32)
    jcfg = jf.FlowConfig(lowres_iterations=200, fullres_iterations=50, two_scale=True)
    j = np.asarray(jf.refine_flow_two_scale(jnp.asarray(I0), jnp.asarray(I1), jnp.asarray(init), jcfg))
    t = tf.refine_flow_two_scale(_t(I0), _t(I1), _t(init), convert.flow_config_from_jax(jcfg)).numpy()
    _multiwarp_close(t, j)


def test_gates_exact(rng):
    h, w = 30, 44
    flow = (rng.normal(size=(h, w, 2)) * 6).astype(np.float32)
    flow[2, 3] = [w / 2, 0.0]  # the magnitude gate's edge
    flow[4, 5, 0] = np.inf
    mask = (rng.random((h, w)) > 0.2).astype(np.float32)
    Ib = (rng.random((h, w)) * 255).astype(np.float32)
    Ib[::7] = 0.0
    Im = (rng.random((h, w)) * 255).astype(np.float32)
    Im[:, ::5] = 0.0
    j = np.asarray(jf.flow_correspondence_gates(jnp.asarray(flow), jnp.asarray(mask), jnp.asarray(Ib), jnp.asarray(Im)))
    t = tf.flow_correspondence_gates(_t(flow), _t(mask), _t(Ib), _t(Im)).numpy()
    assert 0.2 < t.mean() < 0.9
    assert np.array_equal(j, t)


def test_triangulate_flow_matches_jax(rng):
    sc = make_scene(seed=3, width=96, height=64)
    rig = sc.rig
    geom = jd.prepare_frame_geometry(rig.K0, rig.K1, rig.R, rig.T, (96, 64))
    flow = np.zeros((64, 96, 2), np.float32)
    flow[..., 0] = -10 + rng.normal(size=(64, 96)) * 0.5
    valid = rng.random((64, 96)) > 0.1
    cfg = jf.FlowConfig()
    args = (geom.K0, geom.K1, geom.R, geom.T)
    jp, jv = jf.triangulate_flow(jnp.asarray(flow), jnp.asarray(valid), *(jnp.asarray(a, jnp.float32) for a in args),
                                 bool(geom.base_is_cam0), cfg)
    tp, tv = tf.triangulate_flow(_t(flow), _t(valid), *args, bool(geom.base_is_cam0),
                                 convert.flow_config_from_jax(cfg))
    jp, jv = np.asarray(jp), np.asarray(jv)
    assert jv.sum() > 1000
    assert np.array_equal(jv, tv.numpy())
    np.testing.assert_allclose(tp.numpy()[jv], jp[jv], rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def jax_dense_frame():
    sc = make_scene(seed=7, width=256, height=192, wave_amplitude=0.25)
    cfg = jd.DenseStereoConfig(num_disp=96, min_disp=1, plane_ransac_rounds=128, min_triangulated=50)
    res, geom = jd.dense_stereo_frame(sc.img0, sc.img1, sc.rig.K0, sc.rig.K1, sc.rig.R, sc.rig.T, cfg)
    b_img, m_img = (sc.img0, sc.img1) if geom.base_is_cam0 else (sc.img1, sc.img0)
    return dict(scene=sc, res=res, geom=geom, b=np.asarray(b_img, np.float32), m=np.asarray(m_img, np.float32))


def test_flow_frame_matches_jax(jax_dense_frame):
    """flow_reconstruct_frame on the JAX dense frame's disparity and
    validity, both packages (fullres_iterations 100, as tests/test_flow.py)."""
    f = jax_dense_frame
    jcfg = jf.FlowConfig(lowres_iterations=400, fullres_iterations=100)
    jr = jf.flow_reconstruct_frame(f["res"].disparity, f["b"], f["m"], f["geom"], jcfg, min_disp=1.0,
                                   valid_rect=f["res"].valid)
    tr = tf.flow_reconstruct_frame(_t(f["res"].disparity), f["b"], f["m"], f["geom"], convert.flow_config_from_jax(jcfg),
                                   min_disp=1.0, valid_rect=_t(f["res"].valid))
    np.testing.assert_allclose(tr.coarse_flow.numpy(), jr.coarse_flow, rtol=0, atol=1e-3)
    _multiwarp_close(tr.flow.numpy(), jr.flow)
    tv = tr.valid.numpy()
    n = jr.valid.sum()
    assert n > 5000
    assert (tv != jr.valid).sum() <= 0.002 * n
    both = tv & jr.valid
    rel = np.linalg.norm(tr.points.numpy()[both] - jr.points[both], axis=-1) / np.linalg.norm(jr.points[both], axis=-1)
    assert np.median(rel) < 1e-5 and np.mean(rel > 1e-3) < 0.01


def test_port_dense_frame_flow_quality():
    """The port's own dense frame through the port's flow, held to
    tests/test_flow.py's gates: over 5000 points, trimmed-mean elevation
    error under 0.05."""
    sc = make_scene(seed=7, width=256, height=192, wave_amplitude=0.25)
    cfg = td.DenseStereoConfig(num_disp=96, min_disp=1, plane_ransac_rounds=128, min_triangulated=50)
    res, geom = td.dense_stereo_frame(sc.img0, sc.img1, sc.rig.K0, sc.rig.K1, sc.rig.R, sc.rig.T, cfg)
    assert int(res.n_points) > 1000
    b_img, m_img = (sc.img0, sc.img1) if geom.base_is_cam0 else (sc.img1, sc.img0)
    fr = tf.flow_reconstruct_frame(res.disparity, b_img, m_img, geom, tf.FlowConfig(fullres_iterations=100),
                                   min_disp=1.0, valid_rect=res.valid)
    n = int(fr.valid.sum())
    assert n > 5000, n
    err = sc.elevation_error(fr.points.numpy()[fr.valid.numpy()], res.plane.numpy().astype(np.float64))
    err = np.sort(err[np.isfinite(err)])[: int(np.isfinite(err).sum() * 0.999)]
    assert err.mean() < 0.05, err.mean()


@pytest.mark.parametrize("max_motion", [200.0, -1.0])
def test_render_flow_matches_jax(tmp_path, rng, max_motion):
    flow = (rng.normal(size=(36, 50, 2)) * 40).astype(np.float32)
    flow[0, 0] = [np.nan, 1.0]
    flow[1, 1] = [2e9, 0.0]
    flow[2, 2] = [0.0, 0.0]
    jax_render_flow(tmp_path / "j.png", flow, max_motion)
    trender.save_png(tmp_path / "t.png", trender.render_flow(torch.from_numpy(flow), max_motion))
    assert np.array_equal(iio.imread(tmp_path / "j.png"), iio.imread(tmp_path / "t.png"))


def test_ply_files_byte_equal(tmp_path, rng):
    pts = rng.normal(size=(57, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (57, 3)).astype(np.uint8)
    grid = rng.normal(size=(9, 11, 3)).astype(np.float32)
    valid = rng.random((9, 11)) > 0.2
    gcols = rng.integers(0, 256, (int(valid.sum()), 3)).astype(np.uint8)  # one colour a valid vertex
    writers = [
        ("pts.ply", lambda m, p: m.save_ply_points(p, pts, cols)),
        ("pts_grey.ply", lambda m, p: m.save_ply_points(p, pts)),
        ("tri.ply", lambda m, p: m.save_triangulated_ply(p, grid, valid, 0.8, gcols)),
        ("tri_plain.ply", lambda m, p: m.save_triangulated_ply(p, grid, valid, 0.8)),
        ("pts.xyz", lambda m, p: m.save_xyz_ascii(p, pts, stride=2)),
        ("pts.bin", lambda m, p: m.save_xyz_binary(p, pts)),
    ]
    for name, write in writers:
        write(jply, tmp_path / f"j_{name}")
        write(tply, tmp_path / f"t_{name}")
        assert (tmp_path / f"j_{name}").read_bytes() == (tmp_path / f"t_{name}").read_bytes(), name
    assert np.array_equal(tply.load_xyz_binary(tmp_path / "t_pts.bin"), jply.load_xyz_binary(tmp_path / "j_pts.bin"))


@pytest.mark.parametrize("text", ["", "ENABLE_OPTICAL_FLOW=true\n",
                                  "ENABLE_OPTICAL_FLOW=true\nFLOW_REFINEMENT_FULLRES_ITERATIONS=75\n"
                                  "FLOW_REFINEMENT_FULLRES_SMOOTHNESS_FACTOR=120\nFLOW_OPENING_ERODE=2\n"])
def test_flow_config_from_registry(tmp_path, text):
    from wass_tpu.cli import options as jopt
    from wass_tpu.config import registry as jregistry
    from wass_tpu_torch.cli import options as topt
    from wass_tpu_torch.config import registry as tregistry

    cfgfile = tmp_path / "stereo_config.txt"
    cfgfile.write_text(text)
    jopt.register_all()
    topt.register_all()
    jregistry("stereo").load_file(cfgfile)
    tregistry("stereo").load_file(cfgfile)
    j, t = jopt.flow_config_from_registry(), topt.flow_config_from_registry()
    if not text:
        assert j is None and t is None
    else:
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert convert.flow_config_from_jax(j) == t


def test_flow_config_from_jax():
    j = jf.FlowConfig(fullres_iterations=50, two_scale=True, z_max=40.0)
    t = convert.flow_config_from_jax(j)
    assert isinstance(t, tf.FlowConfig)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
