"""Port parity of the prepare stage: the lens model (ops/sampling.py), CLAHE,
the polarimetric path and prepare_frame (wass_tpu_torch, CPU) against the
JAX package's functions, and the lens model against OpenCV.

The JAX functions run eagerly here (each op compiled alone), except where
a test says otherwise: their float32 arithmetic is then the port's, op for
op.  Two stages differ in the last bits and have a tolerance instead:
undistort_points (the JAX fixed-point loop is one compiled fori_loop, where
XLA contracts multiply-adds into FMAs: 1e-4 px) and clahe (jitted in the
JAX package, and the cumulative sum adds in another order: 1e-3 gray
levels).  prepare_frame's device program is jitted in the JAX package,
so its PNGs may differ where a pixel's float value lies within ~1e-4 of an
integer: the uint8 cast truncates.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wass_tpu.io.workdir import Workdir as JWorkdir
from wass_tpu.ops import sampling as js
from wass_tpu.prepare.clahe import clahe as jax_clahe
from wass_tpu.prepare import polar as jpolar
from wass_tpu.prepare import prepare as jprepare
from wass_tpu_torch.io.workdir import Workdir as TWorkdir
from wass_tpu_torch.ops import sampling as ts
from wass_tpu_torch.prepare import clahe as tclahe
from wass_tpu_torch.prepare import polar as tpolar
from wass_tpu_torch.prepare import prepare as tprepare

K = np.array([[150.0, 0, 80], [0, 150, 60], [0, 0, 1]])
DISTS = {
    "5 terms": [-0.1, 0.02, 1e-3, -5e-4, 0.0],
    "8 terms": [-0.1, 0.02, 1e-3, -5e-4, 0.01, 0.002, -0.001, 0.0005],
    "4 terms": [0.05, -0.01, 0.0, 0.0],
}


def _f32(a):
    return np.asarray(a, np.float32)


def _both(a):
    """(jax array, torch tensor) of one float32 array."""
    return jnp.asarray(_f32(a)), torch.from_numpy(_f32(a).copy())


def smooth_image(rng, h=48, w=64):
    """The smooth test image of tests/test_ops.py."""
    base = rng.random((h // 8 + 2, w // 8 + 2)).astype(np.float32)
    return cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC) * 200 + 20


@pytest.mark.parametrize("dist", DISTS.values(), ids=DISTS.keys())
def test_lens_model_matches_jax(rng, dist):
    """distort_points and undistort_image bit-equal; undistort_points within
    1e-4 px (the JAX loop is one compiled program)."""
    pts = np.stack([rng.uniform(-10, 170, 500), rng.uniform(-10, 130, 500)], 1)
    (pj, pt), (kj, kt), (dj, dt) = _both(pts), _both(K), _both(dist)
    np.testing.assert_array_equal(ts.distort_points(pt, kt, dt).numpy(), np.asarray(js.distort_points(pj, kj, dj)))
    np.testing.assert_allclose(ts.undistort_points(pt, kt, dt).numpy(), np.asarray(js.undistort_points(pj, kj, dj)),
                               rtol=0, atol=1e-4)
    ij, it = _both(rng.random((120, 160)) * 255)
    np.testing.assert_array_equal(ts.undistort_image(it, kt, dt).numpy(), np.asarray(js.undistort_image(ij, kj, dj)))


def test_lens_model_matches_cv2(rng):
    """The thresholds of tests/test_ops.py's cv2 checks."""
    img = smooth_image(rng, 120, 160)
    dist = np.array([-0.1, 0.02, 1e-3, -5e-4, 0.0])
    out = ts.undistort_image(torch.from_numpy(img), torch.tensor(_f32(K)), torch.tensor(_f32(dist))).numpy()
    assert np.median(np.abs(out - cv2.undistort(img, K, dist))[8:-8, 8:-8]) < 0.15

    Kb = np.array([[800.0, 0, 640], [0, 800, 480], [0, 0, 1]])
    dist = np.array([-0.2, 0.05, 1e-3, -2e-3, 0.01])
    pts = np.stack([rng.uniform(100, 1180, 50), rng.uniform(100, 860, 50)], axis=1)
    kt, dt = torch.tensor(_f32(Kb)), torch.tensor(_f32(dist))
    d = ts.distort_points(torch.tensor(_f32(pts)), kt, dt)
    np.testing.assert_allclose(ts.undistort_points(d, kt, dt).numpy(), pts, atol=0.1)
    ref = cv2.undistortPoints(pts.reshape(-1, 1, 2), Kb, dist, P=Kb).reshape(-1, 2)
    np.testing.assert_allclose(ts.undistort_points(torch.tensor(_f32(pts)), kt, dt).numpy(), ref, atol=0.05)


@pytest.mark.parametrize("clip", [2.0, 40.0])
@pytest.mark.parametrize("tiles", [(4, 4), (3, 5), (1, 1)], ids=["4x4", "3x5", "1x1"])
def test_clahe_matches_jax(rng, tiles, clip):
    img = _f32(rng.random((96, 128)) * 255)
    img[:40] *= 0.3  # tiles of another contrast
    ty, tx = tiles
    ref = np.asarray(jax_clahe(jnp.asarray(img), clip, tiles_x=tx, tiles_y=ty))
    out = tclahe.clahe(torch.from_numpy(img), clip, tiles_x=tx, tiles_y=ty).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)


@pytest.mark.parametrize("lens", [False, True], ids=["no_lens", "lens"])
@pytest.mark.parametrize("hdr", [True, False], ids=["hdr", "s0"])
def test_polarimetric_process_matches_jax(rng, hdr, lens):
    ij, it = _both(rng.random((96, 128)) * 255)
    kd = (_both(K), _both(DISTS["5 terms"])) if lens else ((None, None), (None, None))
    ref = jpolar.polarimetric_process(ij, kd[0][0], kd[1][0], use_hdr=hdr)
    out = tpolar.polarimetric_process(it, kd[0][1], kd[1][1], use_hdr=hdr)
    for name in ref._fields:
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    a, b, c, d = tpolar.demosaic(it)
    assert torch.equal(c, it[0::2, 0::2]) and torch.equal(a, it[1::2, 1::2]) and b.shape == d.shape == (48, 64)


def _frame(rng, h=96, w=128):
    img0 = smooth_image(rng, h, w) + rng.normal(0, 3, (h, w))
    img1 = smooth_image(rng, h, w) + rng.normal(0, 3, (h, w))
    K0 = np.array([[110.0, 0, w / 2 - 0.5], [0, 110, h / 2 + 0.25], [0, 0, 1]])
    K1 = K0 * [[1.02], [1.02], [1]]
    R = cv2.Rodrigues(np.array([0.01, -0.02, 0.005]))[0]
    T = np.array([[-1.0], [0.02], [0.01]])
    return np.clip(img0, 0, 255).astype(np.float32), np.clip(img1, 0, 255).astype(np.float32), K0, K1, R, T


XML = ("intrinsics_00000000.xml", "intrinsics_00000001.xml", "ext_R.xml", "ext_T.xml")


@pytest.mark.parametrize("case", ["identity", "distorted", "clahe"])
def test_prepare_frame_matches_jax(rng, tmp_path, case):
    """The workdir against the JAX package's: XML files byte-identical; the
    identity case's images identical; otherwise the float images within
    the stage tolerances of the JAX functions run eagerly, and the PNG
    pixels differ by at most 1 gray level on at most 0.1% of the pixels."""
    img0, img1, K0, K1, R, T = _frame(rng)
    d0 = np.zeros(5) if case == "identity" else np.array([-0.08, 0.01, 5e-4, -3e-4, 0.0])
    d1 = np.zeros(5) if case == "identity" else np.array([0.04, 0.0, 0.0, 0.0, 0.0])
    kw = dict(clahe_tile_px_cam0=40, clahe_tile_px_cam1=32, clahe_clip_limit_cam1=3.0) if case == "clahe" else {}
    jw = jprepare.prepare_frame(tmp_path / "jax", img0, img1, K0, d0, K1, d1, jprepare.PrepareConfig(**kw), R, T)
    tw = tprepare.prepare_frame(tmp_path / "port", img0, img1, K0, d0, K1, d1, tprepare.PrepareConfig(**kw), R, T,
                                device="cpu")
    for name in XML:
        assert (tw.path / name).read_bytes() == (jw.path / name).read_bytes(), name
    for cam, (img, Kc, dc) in enumerate(((img0, K0, d0), (img1, K1, d1))):
        pj = JWorkdir(jw.path).load_undistorted(cam)
        pt = TWorkdir(tw.path).load_undistorted(cam)
        if case == "identity":
            np.testing.assert_array_equal(pt, pj)
            np.testing.assert_array_equal(pt, np.clip(img, 0, 255).astype(np.uint8))
            continue
        diff = np.abs(pt.astype(np.int16) - pj.astype(np.int16))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())
        # The float image against the JAX functions run eagerly.
        x = jnp.asarray(img)
        if case == "clahe":
            tile = 40 if cam == 0 else 32
            with jax.disable_jit():
                x = jax_clahe(x, 2.0 if cam == 0 else 3.0, tiles_x=128 // tile, tiles_y=96 // tile)
        ref = np.clip(np.asarray(js.undistort_image(x, jnp.asarray(_f32(Kc)), jnp.asarray(_f32(dc)))), 0, 255)
        out = tprepare.prepare_image(img, Kc, dc, tprepare.PrepareConfig(**kw), cam, device="cpu")
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 if case == "distorted" else 1e-3)


def test_save_stokes_refused(rng, tmp_path):
    """save_stokes, once refused, now writes the Stokes images as the JAX
    prepare_frame does: float32 TIFFs undistorted/0000000{cam}_S{0,1,2}.tiff,
    read back by imageio, within the polarimetric path's tolerance (1e-5,
    test_polarimetric_process_matches_jax); none without save_stokes."""
    import imageio.v3 as iio

    img0, img1, K0, K1, R, T = _frame(rng, 32, 48)
    d0 = np.array(DISTS["5 terms"])
    for hdr in (False, True):
        jw = jprepare.prepare_frame(tmp_path / f"jax{hdr}", img0, img1, K0, d0, K1, np.zeros(5),
                                    jprepare.PrepareConfig(demosaic=True, hdr=hdr, save_stokes=True))
        tw = tprepare.prepare_frame(tmp_path / f"port{hdr}", img0, img1, K0, d0, K1, np.zeros(5),
                                    tprepare.PrepareConfig(demosaic=True, hdr=hdr, save_stokes=True), device="cpu")
        names = sorted(p.name for p in (jw.path / "undistorted").glob("*.tiff"))
        assert names == sorted(p.name for p in (tw.path / "undistorted").glob("*.tiff")) and len(names) == 6
        for name in names:
            want, got = iio.imread(jw.path / "undistorted" / name), iio.imread(tw.path / "undistorted" / name)
            assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (32, 48)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=name)
        assert TWorkdir(tw.path).load_undistorted(0).shape == (32, 48)
    wd = tprepare.prepare_frame(tmp_path / "wd", img0, img1, K0, np.zeros(5), K1, np.zeros(5),
                                tprepare.PrepareConfig(demosaic=True, hdr=True), device="cpu")
    assert not list((wd.path / "undistorted").glob("*.tiff"))


def test_render_raw_through_lens(tmp_path):
    """The raw frames of the prepare smoke run: without a lens they are the
    scene's pinhole images; through a lens, undistort_image takes them back
    to those images up to one bilinear resampling; the cache returns them."""
    from wass_tpu_torch.testing import load_or_render_raw
    from wass_tpu_torch.testing.synthetic import make_rig, make_scene, render_raw

    rig = make_rig(width=256, height=192)
    sc = make_scene(seed=3, width=256, height=192, wave_amplitude=0.25, rig=rig)
    r0, r1 = render_raw(3, rig, np.zeros(5), np.zeros(5), wave_amplitude=0.25)
    np.testing.assert_array_equal(r0, sc.img0)
    np.testing.assert_array_equal(r1, sc.img1)
    d0, d1 = [-0.2, 0.05, 1e-3, -1e-3, 0.0], [-0.15, 0.02, 0.0, 0.0, 0.0]
    raw = load_or_render_raw(rig, 3, d0, d1, tmp_path)
    assert np.array_equal(raw[0], load_or_render_raw(rig, 3, d0, d1, tmp_path)[0]) and len(list(tmp_path.iterdir())) == 1
    inner = np.s_[4:-4, 4:-4]
    for img, ref, Kc, dc in ((raw[0], sc.img0, rig.K0, d0), (raw[1], sc.img1, rig.K1, d1)):
        back = ts.undistort_image(torch.from_numpy(img), torch.tensor(_f32(Kc)), torch.tensor(_f32(dc))).numpy()
        moved, residual = np.abs(img - ref)[inner].mean(), np.abs(back - ref)[inner].mean()
        print(f"mean |raw - ideal| {moved:.3f}, |undistorted - ideal| {residual:.3f}")
        assert residual < 0.25 * moved
