"""The port's post modules (wass_tpu_torch/post/) against the JAX
package's (wass_tpu/post/) on the same inputs, made from a numpy seed, on
the CPU (the plain version of the visibility march).  Tolerances, each
with its reason:

* spectra: float32 FFTs in both packages (x64 off: jnp.asarray of float64
  data is float32), two FFT libraries: S within 1e-5 of max S; Hm0, Tm01
  and Tp within 1e-5 relative; the frequencies equal;
* temporal_butterworth, streaming_time_mean, zero_mean, bg_radiance,
  vats_threshold, radiance_threshold: the same host numpy/scipy code,
  bit-equal;
* spatial_butterworth_lowpass: 1e-5 of the field's range (float32 FFTs);
* the visibility: against the JAX functions under jax.disable_jit() (the
  while_loop op by op, as the port runs its normalisations) the occlusion
  equal and the incidence within 3e-5 degrees (torch's and XLA's arccos
  differ by up to 2 float32 ulps, the product by 180/pi adds one: 4 ulps
  at 64-128 degrees); against the jitted JAX functions
  (whose normalisations XLA contracts into FMAs) at most 0.1% of the
  cells' occlusion differ;
* radiance and the polarimetric averages: 1e-6 (float32 bilinear weights).
"""

import h5py
import jax
import numpy as np
import pytest
import torch

from wass_tpu.post import filters as jf
from wass_tpu.post import geometry as jg
from wass_tpu.post import ooc as jo
from wass_tpu.post import polarimetric as jp
from wass_tpu.post import radiance as jr
from wass_tpu.post import spectra as js

from wass_tpu_torch.io import hdf5
from wass_tpu_torch.post import filters as tf
from wass_tpu_torch.post import geometry as tg
from wass_tpu_torch.post import ooc as to
from wass_tpu_torch.post import polarimetric as tp
from wass_tpu_torch.post import radiance as tr
from wass_tpu_torch.post import spectra as ts
from wass_tpu_torch.post import visibility_kernels as vk

from torch_post_data import wave_cube

CPU = "cpu"


def _cube(T, H, W, seed, holes=True):
    rng = np.random.default_rng(seed)
    XX, YY = np.meshgrid(np.linspace(-6, 6, W), np.linspace(-5, 5, H))
    Z = wave_cube(XX, YY, T, 4.0, seed) + 0.01 * rng.standard_normal((T, H, W))
    if holes:
        Z[2:5, 3:6, 10:14] = np.nan
        Z[:, H - 2, 1] = np.nan
    return XX, YY, Z


@pytest.mark.parametrize("T, nperseg, rangespan, seed", [(200, 64, 5, 0), (96, 512, 3, 1), (150, 33, 0, 2)])
def test_spectrum_matches_jax(T, nperseg, rangespan, seed):
    _, _, Z = _cube(T, 40, 44, seed)
    fj, Sj, cj = js.compute_spectrum(Z * 1000, dt=0.25, nperseg=nperseg, rangespan=rangespan, scale=1e-3)
    fp, Sp, cp = ts.compute_spectrum(Z * 1000, dt=0.25, nperseg=nperseg, rangespan=rangespan, scale=1e-3, device=CPU)
    np.testing.assert_array_equal(fj, fp)
    np.testing.assert_array_equal(cj, cp)
    assert Sp.dtype == Sj.dtype == np.float32
    assert np.abs(Sj - Sp).max() <= 1e-5 * Sj.max()
    a, b = js.spectrum_stats(fj, Sj), ts.spectrum_stats(fp, Sp)
    np.testing.assert_allclose([b.hm0, b.tm01, b.tp], [a.hm0, a.tm01, a.tp], rtol=1e-5)
    assert a.fp == b.fp


@pytest.mark.parametrize("T, segments, seed", [(96, 10, 0), (120, 4, 1)])
def test_3d_spectrum_matches_jax(T, segments, seed):
    _, _, Z = _cube(T, 48, 44, seed)
    Sj, KXj, KYj, fj = js.compute_3d_spectrum(Z * 1000, du=0.25, dt=0.25, segments=segments, datascale=1e-3)
    Sp, KXp, KYp, fp = ts.compute_3d_spectrum(Z * 1000, du=0.25, dt=0.25, segments=segments, datascale=1e-3,
                                              device=CPU)
    for a, b in ((KXj, KXp), (KYj, KYp), (fj, fp)):
        np.testing.assert_array_equal(a, b)
    assert Sp.shape == Sj.shape and Sp.dtype == np.float64
    assert np.abs(Sj - Sp).max() <= 1e-5 * Sj.max()


@pytest.mark.parametrize("kind, cutoff", [("lowpass", 1.0), ("highpass", 0.3)])
def test_temporal_butterworth_is_the_same_scipy_path(kind, cutoff):
    _, _, Z = _cube(64, 32, 36, 3)
    want = jf.temporal_butterworth(Z, fps=4.0, cutoff_hz=cutoff, kind=kind)
    got = tf.temporal_butterworth(Z, fps=4.0, cutoff_hz=cutoff, kind=kind)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("frames", [(5, 32, 48), (32, 48)])
def test_spatial_lowpass_matches_jax(frames):
    _, _, Z = _cube(5, 32, 48, 4)
    Z = Z if len(frames) == 3 else Z[0]
    want = jf.spatial_butterworth_lowpass(Z, du=0.25, cutoff=0.4)
    got = tf.spatial_butterworth_lowpass(Z, du=0.25, cutoff=0.4, device=CPU)
    assert got.shape == want.shape and np.array_equal(np.isnan(got), np.isnan(want))
    assert np.nanmax(np.abs(got - want)) <= 1e-5 * (np.nanmax(Z) - np.nanmin(Z))


def test_zero_mean_and_normals_are_the_same_host_code():
    XX, YY, Z = _cube(16, 32, 36, 5)
    np.testing.assert_array_equal(tf.zero_mean(Z), jf.zero_mean(Z))
    for a, b in zip(tg.compute_slope_and_normals(XX, YY, Z[0]), jg.compute_slope_and_normals(XX, YY, Z[0])):
        np.testing.assert_array_equal(a, b)


@pytest.fixture
def tiny_budget(monkeypatch):
    monkeypatch.setenv("WASS_POST_MEMORY_MB", "0.05")


def test_streaming_matches_jax(tmp_path, tiny_budget):
    """The blocks, the NaN-aware float64 time mean and the time-wise and
    frame-wise streams over the port's file equal the JAX package's over
    an h5py file holding the same cube."""
    _, _, Z = _cube(48, 32, 36, 6)
    Z = (Z * 1000).astype(np.float32)
    assert list(to.iter_col_blocks(Z.shape, 4)) == list(jo.iter_col_blocks(Z.shape, 4))
    assert list(to.iter_time_slabs(Z.shape, 4, 4)) == list(jo.iter_time_slabs(Z.shape, 4, 4))
    assert len(list(to.iter_col_blocks(Z.shape, 4))) > 4 and len(list(to.iter_time_slabs(Z.shape, 4))) > 4
    w = hdf5.Writer(tmp_path / "port.h5")
    w.create_dataset(w.root, "Z", Z.shape, hdf5.numeric(np.float32), Z)
    w.close()
    with h5py.File(tmp_path / "jax.h5", "w") as f:
        f.create_dataset("Z", data=Z, chunks=(8, 8, 8))

    def lowpass(blk):
        return jf.temporal_butterworth(blk, fps=4.0, cutoff_hz=0.5).astype(np.float32)

    def shift(blk):
        return blk * np.float32(0.5) + np.float32(3)

    with h5py.File(tmp_path / "jax.h5", "r+") as fj, hdf5.H5File(tmp_path / "port.h5", "r+") as fp:
        mj, mp = jo.streaming_time_mean(fj["Z"]), to.streaming_time_mean(fp["Z"])
        np.testing.assert_array_equal(mp, mj)
        assert mp.dtype == np.float64 and np.isfinite(mp).all()
        jo.apply_timewise(fj, "Z", "Zt", lowpass, dtype="f4")
        to.apply_timewise(fp, "Z", "Zt", lowpass, dtype="f4")
        jo.apply_framewise(fj, "Z", "Z", shift)
        to.apply_framewise(fp, "Z", "Z", shift)
    with h5py.File(tmp_path / "jax.h5", "r") as fj, h5py.File(tmp_path / "port.h5", "r") as fp:
        for name in ("Z", "Zt"):
            assert fp[name].dtype == fj[name].dtype
            np.testing.assert_array_equal(fp[name][...], fj[name][...])


def _rays(H, W, seed):
    rng = np.random.default_rng(seed)
    d = np.dstack([np.full((H, W), rng.uniform(-1, 1)), np.full((H, W), rng.uniform(-1, 1)),
                   np.full((H, W), rng.uniform(0.1, 0.4))])
    return d + 0.02 * rng.standard_normal((H, W, 3)) * [1, 1, 0]


@pytest.mark.parametrize("invert_y", [False, True])
@pytest.mark.parametrize("hole", [False, True])
def test_occlusion_mask_matches_jax(invert_y, hole):
    _, _, Z = _cube(1, 40, 44, 7, holes=False)
    Z = Z[0] * 4
    if hole:
        Z[10:13, 20:24] = np.nan
    d = _rays(40, 44, 8)
    with jax.disable_jit():
        want = jg.compute_occlusion_mask(Z, d, invert_y)
    got = tg.compute_occlusion_mask(Z, d, invert_y, device=CPU)
    assert got.dtype == np.uint8 and got.shape == Z.shape
    np.testing.assert_array_equal(got, want)
    assert np.mean(got != jg.compute_occlusion_mask(Z, d, invert_y)) <= 1e-3
    if hole:  # jnp.max of a frame with a hole is NaN: every ray stops at its first step
        assert not got.any()
    else:
        assert 0 < got.mean() < 1


CAMS = [np.array([0.0, -30.0, 4.0]), np.array([20.0, 25.0, 9.0]), np.array([-40.0, 10.0, 3.0])]


@pytest.mark.parametrize("cam", range(len(CAMS)))
@pytest.mark.parametrize("hole", [False, True])
def test_visibility_batch_matches_jax(cam, hole):
    XX, YY, Z = _cube(6, 40, 48, 9 + cam, holes=False)
    if hole:
        Z[2:5, 3:6, 10:14] = np.nan
    dx = XX[0, 1] - XX[0, 0]
    with jax.disable_jit():
        oj, ij = jg.compute_visibility_batch(Z, XX, YY, CAMS[cam], dx)
    op, ip = tg.compute_visibility_batch(Z, XX, YY, CAMS[cam], dx, device=CPU)
    assert op.dtype == np.uint8 and ip.dtype == np.float32 and op.shape == ip.shape == Z.shape
    np.testing.assert_array_equal(op, oj)
    assert np.array_equal(np.isnan(ip), np.isnan(ij))
    assert np.nanmax(np.abs(ip - ij)) <= 3e-5
    ojit, _ = jg.compute_visibility_batch(Z, XX, YY, CAMS[cam], dx)
    assert np.mean(op != ojit) <= 1e-3
    assert (op[0] > (ip[0] >= 88)).any()  # the march occludes cells that are not grazing
    if hole:
        assert (op[2:5] == (ip[2:5] >= 88)).all()  # a hole's frame: no ray marches, only grazing cells count


def test_march_plain_stops_like_the_jax_loop():
    """The plain march on rays that leave the grid, climb over maxz, or
    meet the surface at the first step, and with max_steps cut."""
    Z = torch.zeros((2, 4, 5))
    Z[0, 1, 2] = 5.0
    d = torch.tensor([[1.0, 0.0, 0.1]]).repeat(40, 1)
    maxz = torch.tensor([5.0, 0.0])
    occ = vk.march(Z, d, maxz, 10)
    assert occ.dtype == torch.uint8 and occ.shape == (2, 4, 5)
    # Frame 0: the cells left of the peak in its row see it; frame 1 is
    # flat, every ray climbs over maxz = 0 at once.
    assert occ[0].tolist() == [[0] * 5, [1, 1, 0, 0, 0], [0] * 5, [0] * 5] and not occ[1].any()
    assert not vk.march(Z, d, maxz, 0).any()


def test_radiance_matches_jax():
    rng = np.random.default_rng(11)
    XX, YY = np.meshgrid(np.linspace(-4, 4, 40), np.linspace(-20, -12, 36))
    Z = 0.3 * np.sin(XX) * np.cos(YY)
    img = rng.integers(0, 256, (64, 96)).astype(np.float32)
    P = np.array([[0.2, 0.0, 0.1, 0.0], [0.0, 0.2, 0.05, 3.2], [0.0, 0.01, 0.0, 1.0], [0, 0, 0, 1.0]])
    want = jr.radiance_frame(img, Z, XX, YY, P)
    got = tr.radiance_frame(img, Z, XX, YY, P, device=CPU)
    assert got.shape == want.shape and 0.9 < np.mean(got > 0)
    assert np.abs(got - want).max() <= 1e-6


def test_radiance_thresholds_are_the_same_host_code():
    rng = np.random.default_rng(12)
    rad = rng.random((12, 20, 24)).astype(np.float32) ** 2
    bg = tr.bg_radiance(rad, 5)
    np.testing.assert_array_equal(bg, jr.bg_radiance(rad, 5))
    assert tr.vats_threshold(rad[0]) == jr.vats_threshold(rad[0])
    for vats in (False, True):
        np.testing.assert_array_equal(tr.radiance_threshold(rad, bg, 0.3, vats), jr.radiance_threshold(rad, bg, 0.3, vats))


def test_polarimetric_accumulator_matches_jax():
    rng = np.random.default_rng(13)
    XX, YY = np.meshgrid(np.linspace(-4, 4, 24), np.linspace(-20, -12, 20))
    P = np.array([[0.2, 0.0, 0.1, 0.0], [0.0, 0.2, 0.05, 3.2], [0.0, 0.01, 0.0, 1.0], [0, 0, 0, 1.0]])
    cam = np.array([0.0, -40.0, 10.0])
    accs = [jp.PolarimetricAccumulator.zeros(XX.shape), tp.PolarimetricAccumulator.zeros(XX.shape)]
    for i in range(3):
        Z = 0.3 * np.sin(XX + i) * np.cos(YY)
        Z[3, 4] = np.nan
        S = [rng.random((64, 96)).astype(np.float32) for _ in range(3)]
        accs[0] = jp.accumulate_frame(accs[0], Z, XX, YY, *S, P, cam)
        accs[1] = tp.accumulate_frame(accs[1], Z, XX, YY, *S, P, cam, device=CPU)
    assert accs[1].n_frames == 3 and 0.9 < accs[1].valid.mean() / 3 < 1
    for a, b in zip(accs[0].finalize(), accs[1].finalize()):
        assert a.shape == b.shape and np.abs(a - b).max() <= 1e-6
    np.testing.assert_array_equal(accs[0].valid, accs[1].valid)
