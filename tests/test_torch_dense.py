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


def _step_surface(rng):
    """A sloped, rippled surface with a 5-unit step, seen from above, a
    quarter of its pixels invalid, and a plane near it."""
    H, W = 40, 56
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    z = 10.0 + 0.01 * xx + 0.02 * yy + 0.2 * np.sin(xx / 5.0)
    z[yy > 30] += 5.0
    pts = np.stack([(xx - W / 2) * z / 100, (yy - H / 2) * z / 100, z], -1).astype(np.float32)
    valid = rng.random((H, W)) > 0.25
    plane = np.array([0.01, -0.02, 0.9, -9.5])
    plane[:3] /= np.linalg.norm(plane[:3])
    return pts, valid, plane.astype(np.float32)


def _surface(rng, H, W, hole_share, jump=False):
    """A point grid (x, y 0.01 apart a pixel; z a slope across the rows, a
    gentle wave along them and noise), with a share of invalid pixels and
    optionally a depth discontinuity, and a plane near it.  On a wide grid
    a pixel's step along a row is under 127 quanta in every component, as
    on a production-width frame; on a narrow one it is not."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    z = 10 + 2.0 * yy / H + 0.01 * np.sin(xx / 20.0) * np.cos(yy / 7.0) + rng.normal(0, 1e-4, (H, W))
    if jump:
        z[H // 3:H // 2, W // 4:W // 2] += 2.0
    pts = np.stack([xx * 0.01, yy * 0.01, z], -1).astype(np.float32)
    valid = rng.random((H, W)) >= hole_share
    n = np.array([0.01, -0.02, 1.0])
    plane = np.append(n / np.linalg.norm(n), -10.0).astype(np.float32)
    return pts, valid, plane


SURFACES = {"step": _step_surface,
            "wide_smooth": lambda rng: _surface(rng, 24, 640, 0.0),
            "wide_speckled": lambda rng: _surface(rng, 24, 640, 0.25, jump=True),
            "narrow": lambda rng: _surface(rng, 32, 96, 0.1)}


@pytest.mark.parametrize("surface", sorted(SURFACES))
def test_export_payload_identical(rng, surface):
    """Given JAX's points, valid mask and plane: the u16 payload and its
    float header are byte-identical, over the whole (H*W, 3) buffer and
    over the first n_points rows the finalizer fetches."""
    pts, valid, plane = SURFACES[surface](rng)
    H, W = valid.shape
    q_j, mins_j, scales_j = jd._stage_export(jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(plane))
    q_j = np.asarray(q_j)
    whole, mins_t, scales_t = td.export_u16(_t(pts), _t(valid), _t(plane), H * W)
    assert whole.shape == q_j.shape and td.fetch_u16(whole).tobytes() == q_j.tobytes()
    q_t, mins_t, scales_t = td.export_u16(_t(pts), _t(valid), _t(plane))
    n = int(valid.sum())
    assert q_t.shape == (n, 3) and td.fetch_u16(q_t).tobytes() == q_j[:n].tobytes()
    assert mins_t.numpy().astype(np.float64).tobytes() == np.asarray(mins_j, np.float64).tobytes()
    assert scales_t.numpy().astype(np.float64).tobytes() == np.asarray(scales_j, np.float64).tobytes()


def test_fetch_u16_keeps_every_value():
    q = torch.tensor([[0, 1, 32767], [32768, 65534, 65535]], dtype=torch.int32)
    out = td.fetch_u16(q)
    assert out.dtype == np.uint16 and out.tolist() == q.tolist()


@pytest.mark.parametrize("n", [1, 17, 2240, 65537])
def test_plane_frame_matches_compiled_export(n):
    """The plane-frame transform, given the same rotation and translation,
    bit-equal to the reference's compiled `pts @ Rp.T + Tp`
    (wass_tpu/stereo/dense.py _stage_export) over points from 1e-2 to 1e3
    in size, whatever BLAS kernel torch's `@` would take."""
    rng = np.random.default_rng(n)
    pts = (rng.standard_normal((n, 3)) * rng.choice([1e-2, 1.0, 30.0, 1e3], (n, 1))).astype(np.float32)
    Rp = rng.standard_normal((3, 3)).astype(np.float32)
    Tp = (rng.standard_normal(3) * 10).astype(np.float32)
    ref = jax.jit(lambda p, r, t: p @ r.T + t)(jnp.asarray(pts), jnp.asarray(Rp), jnp.asarray(Tp))
    np.testing.assert_array_equal(td.plane_frame(_t(pts), _t(Rp), _t(Tp)).numpy(), np.asarray(ref))


def _round_f32(x):
    """The float32 nearest to the rational x, ties to even."""
    from fractions import Fraction

    f = np.float32(float(x))
    cands = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - x), int(np.array(v).view(np.int32)) & 1))


def test_fma32_rounds_once(rng):
    """fma32 against exact rational arithmetic: random triples, products
    that cancel c, and a sum just above a float32 tie, where rounding the
    float64 sum to float32 directly would round the wrong way."""
    from fractions import Fraction

    a = (rng.standard_normal(2000) * 10.0 ** rng.integers(-3, 4, 2000)).astype(np.float32)
    b = rng.standard_normal(2000).astype(np.float32)
    c = (rng.standard_normal(2000) * 10.0 ** rng.integers(-3, 4, 2000)).astype(np.float32)
    c[:500] = -(a[:500] * b[:500])  # cancellation
    # exact a * b + c = 1 + 2^-24 + 2^-70: rounds up to 1 + 2^-23
    a = np.append(a, np.float32(-(1 + 2.0**-23)))
    b = np.append(b, np.float32((1 - 2.0**-23) * 2.0**-24))
    c = np.append(c, np.float32(1 + 2.0**-23))
    exact = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                      for x, y, z in zip(a, b, c)], np.float32)
    # without the tie (float64 sums rounded once), then with it (rounded to odd first)
    np.testing.assert_array_equal(td.fma32(_t(a[:-1]), _t(b[:-1]), _t(c[:-1])).numpy(), exact[:-1])
    out = td.fma32(_t(a), _t(b), _t(c)).numpy()
    np.testing.assert_array_equal(out, exact)
    assert out[-1] == np.float32(1 + 2.0**-23)


def _doubtful(a, b, c) -> bool:
    """Whether a float64 sum a * b + c of fma32's lands where rounding it to
    float32 alone could round the exact value the wrong way: on a float32
    tie, or, not 0, below float32's normal range."""
    s = a.double() * b.double() + c.double()
    return bool((((s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000) | ((s != 0) & (s.abs() < 2.0**-126))).any())


def _fma_triples(rng, case):
    """2000 float32 triples: in float32's normal range with no doubtful sum,
    or with products and sums below it."""
    a = (rng.standard_normal(2000) * 10.0 ** rng.integers(-3, 4, 2000)).astype(np.float32)
    b = rng.standard_normal(2000).astype(np.float32)
    c = (rng.standard_normal(2000) * 10.0 ** rng.integers(-3, 4, 2000)).astype(np.float32)
    if case == "subnormal":
        a = (a * np.float32(1e-19)).astype(np.float32)
        b = (b * np.float32(1e-20)).astype(np.float32)
        c = (rng.standard_normal(2000) * 1e-39).astype(np.float32)
    return a, b, c


@pytest.mark.parametrize("case", ["no_doubt", "subnormal"])
def test_fma32_rounds_once_on_every_element(rng, case):
    """fma32 takes its step to odd on every element, doubtful or not:
    against exact rational arithmetic on triples with no doubtful sum, where
    rounding the float64 sum alone is already right, and on sums below
    float32's normal range, where it is not."""
    from fractions import Fraction

    a, b, c = _fma_triples(rng, case)
    assert _doubtful(_t(a), _t(b), _t(c)) == (case == "subnormal")
    exact = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                      for x, y, z in zip(a, b, c)], np.float32)
    out = td.fma32(_t(a), _t(b), _t(c)).numpy()
    np.testing.assert_array_equal(out.view(np.int32), exact.view(np.int32))
    if case == "no_doubt":
        # Rounded once from float64, as the fix's absence would have it.
        direct = (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)
        np.testing.assert_array_equal(out.view(np.int32), direct.view(np.int32))


def _frame_result(pts, valid, plane, ok=True):
    H, W = valid.shape
    return td.DenseFrameResult(points=_t(pts), valid=_t(valid), plane=_t(plane), plane_ok=torch.tensor(ok),
                               disparity=torch.zeros((H, W)), n_points=_t(valid).sum())


# export_frame's cases: a surface of SURFACES, and whether the float64 sums
# of its plane-frame transform hold a doubtful one (a float32 tie: the step
# and narrow surfaces hold some; "subnormal" plants a point whose z lies
# below float32's normal range on the wide smooth one).
EXPORT_CASES = {"wide_smooth": False, "wide_speckled": False, "step": True, "narrow": True, "subnormal": True}


@pytest.mark.parametrize("c2f", [False, True], ids=["full_range", "c2f"])
@pytest.mark.parametrize("case", sorted(EXPORT_CASES))
def test_export_frame_is_the_writers_export(rng, case, c2f):
    """export_frame's payload rows [:n_points] and its header, bit for bit,
    are what the writer read through export_u16, fetch_u16 and the plane's
    reads: on frames with a doubtful fma32 sum in their plane-frame
    transform and on frames without."""
    from wass_tpu_torch.core.geometry import rt_from_plane

    pts, valid, plane = SURFACES["wide_smooth" if case == "subnormal" else case](rng)
    if case == "subnormal":
        pts[0, 0] = (0.0, 0.0, 1e-40)
        valid[0, 0] = True
    res = _frame_result(pts, valid, plane)
    Rp = rt_from_plane(res.plane)[0]
    P = res.points.reshape(-1, 3)
    acc = P[:, 0:1] * Rp[:, 0]
    doubt = _doubtful(P[:, 1:2], Rp[:, 1], acc) or _doubtful(P[:, 2:3], Rp[:, 2], td.fma32(P[:, 1:2], Rp[:, 1], acc))
    assert doubt == EXPORT_CASES[case]
    diag = {"coverage": torch.tensor(0.8125), "offband": torch.tensor(3e-4), "fallback": None} if c2f else None

    ex = td.export_frame(res, diag)
    H, W = valid.shape
    n = int(valid.sum())
    assert ex.payload.shape == (H * W + 1, 3) and ex.payload.dtype == torch.int16
    assert ex.header.shape == (td.HEADER_LEN,) and ex.header.dtype == torch.float64
    q, mins, scales = td.export_u16(res.points, res.valid, res.plane, int(res.n_points))
    assert ex.payload[:n].numpy().view(np.uint16).tobytes() == td.fetch_u16(q).tobytes()
    head = td.unpack_header(ex.header.numpy())
    assert head["n_points"] == int(res.n_points) and head["plane_ok"] is bool(res.plane_ok)
    assert head["plane"].tobytes() == res.plane.cpu().numpy().astype(np.float64).tobytes()
    assert head["mins"].tobytes() == mins.cpu().numpy().astype(np.float64).tobytes()
    assert head["scales"].tobytes() == scales.cpu().numpy().astype(np.float64).tobytes()
    if c2f:
        assert (head["coverage"], head["offband"]) == (float(diag["coverage"]), float(diag["offband"]))
    else:
        assert np.isnan(head["coverage"]) and np.isnan(head["offband"])


def test_export_frame_of_a_failed_fit(rng):
    """A frame whose plane fit failed (a nan plane, plane_ok false) exports
    without error; its header says so, and the writer reads no payload."""
    pts, valid, _plane = SURFACES["narrow"](rng)
    ex = td.export_frame(_frame_result(pts, valid, np.full(4, np.nan, np.float32), ok=False))
    head = td.unpack_header(ex.header.numpy())
    assert head["plane_ok"] is False and np.isnan(head["plane"]).all() and head["n_points"] == int(valid.sum())


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
