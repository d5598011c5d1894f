"""The port's gridding stage (wass_tpu_torch.grid) against the JAX package
on the CPU: setup and config.mat, the cell bins, the median stack, the
IDW and DCT fills, the outlier votes and whole frames.

The JAX package's random draws (jax.random permutations and uniforms)
cannot be reproduced in torch, so the port's functions take them as
tensors; these tests build them from the JAX package's keys."""

import numpy as np
import pytest
import scipy.io as sio
import torch

import jax
import jax.numpy as jnp

import wass_tpu.grid.gridding as jg
import wass_tpu.grid.interpolators as ji
import wass_tpu.grid.outliers as jo
import wass_tpu.grid.setup as jsetup
from wass_tpu.io.workdir import Workdir as JaxWorkdir
from wass_tpu.io.xyzc import load_camera_mesh

import wass_tpu_torch.grid.gridding as tg
import wass_tpu_torch.grid.interpolators as ti
import wass_tpu_torch.grid.outliers as to
import wass_tpu_torch.grid.setup as tsetup

from torch_grid_data import AREA, BASELINE, jax_perms, jax_x0, write_grid_sequence

CENTER = tuple(float(v) for v in AREA[0].split(","))
SIZE = float(AREA[1])


@pytest.fixture(scope="module")
def wds(tmp_path_factory):
    return write_grid_sequence(tmp_path_factory.mktemp("gridseq"), n_frames=2)


def _setups(wd, Nx, Ny):
    plane = wd.load_plane()
    args = (plane, BASELINE, CENTER, SIZE, SIZE * Ny / Nx, Nx, Ny)
    return jsetup.grid_setup(JaxWorkdir(wd.path), *args, fps=4.0), tsetup.grid_setup(wd, *args, fps=4.0)


def jax_bins(wd, setup):
    """gridding.py:97-113 of the JAX package, on the host."""
    mesh = load_camera_mesh(wd.path / "mesh_cam.xyzC")
    ma = setup.Rpl @ mesh + setup.Tpl
    ma[2, :] *= -1.0
    ma = ma * setup.baseline
    H, W = setup.XX.shape
    px = np.floor((ma[0] - setup.xmin) / (setup.xmax - setup.xmin) * (W - 1) + 0.5).astype(np.int64)
    py = np.floor((ma[1] - setup.ymin) / (setup.ymax - setup.ymin) * (H - 1) + 0.5).astype(np.int64)
    good = (px >= 0) & (px < W) & (py >= 0) & (py < H)
    return ma, px, py, good


@pytest.mark.parametrize("Nx, Ny", [(32, 32), (48, 40)])
def test_setup_and_config_mat_bit_equal(wds, tmp_path, Nx, Ny):
    js, ts = _setups(wds[0], Nx, Ny)
    for f in js.__dataclass_fields__:
        a, b = getattr(js, f), getattr(ts, f)
        assert np.array_equal(a, b), f
    js.save_mat(tmp_path / "jax.mat")
    ts.save_mat(tmp_path / "port.mat")
    ja, pa = (tmp_path / "jax.mat").read_bytes(), (tmp_path / "port.mat").read_bytes()
    assert ja[128:] == pa[128:]  # everything after the header's creation time
    # load_mat reads back what the JAX console's inline loadmat reads.
    back = tsetup.GridSetup.load_mat(tmp_path / "jax.mat")
    m = sio.loadmat(str(tmp_path / "jax.mat"))
    for f in ("XX", "YY", "KX_ab", "KY_ab", "Rpl", "Tpl", "P0plane", "Cam1toGrid", "K0"):
        assert np.array_equal(getattr(back, f), m[f]), f
    assert np.array_equal(back.P0cam, js.P0cam) and back.baseline == js.baseline and back.fps == js.fps
    for f in ("xmin", "xmax", "ymin", "ymax", "zmin", "zmax", "x_spacing", "y_spacing"):
        assert getattr(back, f) == getattr(js, f), f


@pytest.mark.parametrize("frame", [0, 1])
@pytest.mark.parametrize("Nx, Ny", [(32, 32), (64, 48)])
def test_bins_match_jax(wds, frame, Nx, Ny):
    """The port's float64 decode and transforms on the device put every
    point in the JAX package's cell; a point may change cell only within
    1e-9 of a cell edge (the host BLAS sums the 3x3 products in another
    order)."""
    js, ts = _setups(wds[0], Nx, Ny)
    ma, px, py, good = jax_bins(wds[frame], js)
    tm = tg.align_mesh(tg.load_mesh(wds[frame].path / "mesh_cam.xyzC", "cpu"), ts)
    np.testing.assert_allclose(tm.numpy(), ma, rtol=0, atol=1e-12)
    tpx, tpy, tgood = (t.numpy() for t in tg.bin_points(tm, ts))
    H, W = js.XX.shape
    diff = (tpx != np.clip(px, 0, W - 1)) | (tpy != np.clip(py, 0, H - 1)) | (tgood != good)
    ux = (ma[0] - js.xmin) / (js.xmax - js.xmin) * (W - 1) + 0.5
    uy = (ma[1] - js.ymin) / (js.ymax - js.ymin) * (H - 1) + 0.5
    edge = np.minimum(np.abs(ux - np.round(ux)), np.abs(uy - np.round(uy)))
    assert not (diff & (edge > 1e-9)).any(), int(diff.sum())
    assert good.sum() > 100 and (~good).sum() > 100  # points on and off the grid


@pytest.mark.parametrize("nreps", [1, 2, 5, 10])
def test_nanmedian_bit_equal(nreps):
    """jnp.nanmedian's linear quantile, with all-NaN columns, even and odd
    counts and both signs."""
    rng = np.random.default_rng(nreps)
    ZZ = rng.standard_normal((nreps, 40, 30)).astype(np.float32) * np.float32(1e3)
    ZZ[rng.random(ZZ.shape) < 0.4] = np.nan
    ZZ[:, :3] = np.nan
    want = np.asarray(jax.jit(lambda a: jnp.nanmedian(a, axis=0))(jnp.asarray(ZZ)))
    got = tg.nanmedian(torch.as_tensor(ZZ)).numpy()
    assert np.array_equal(want, got, equal_nan=True)


@pytest.mark.parametrize("subsample", [100.0, 50.0, 10.0])
@pytest.mark.parametrize("Nx, Ny", [(32, 32), (24, 40)])
def test_median_stack_bit_equal(wds, subsample, Nx, Ny):
    """Last-write-wins in subsample order and the linear nanmedian, bit for
    bit, with the JAX draws: duplicate cells, off-grid points, even and odd
    valid counts a cell, all-NaN cells."""
    js, ts = _setups(wds[0], Nx, Ny)
    ma, px, py, good = jax_bins(wds[0], js)
    H, W = js.XX.shape
    n_use = max(1, int(len(px) * subsample // 100))
    perms = jax_perms(0, 10, len(px), n_use)
    cx, cy = np.clip(px, 0, W - 1), np.clip(py, 0, H - 1)
    want = np.asarray(jg._median_stack(jnp.asarray(cx, jnp.int32), jnp.asarray(cy, jnp.int32),
                                       jnp.asarray(ma[2], jnp.float32), jnp.asarray(good),
                                       jax.random.PRNGKey(0), (H, W), 10, n_use))
    got = tg._median_stack(torch.as_tensor(cx), torch.as_tensor(cy), torch.as_tensor(ma[2]).float(),
                           torch.as_tensor(good), (H, W), 10, n_use, perms=torch.as_tensor(perms)).numpy()
    assert np.array_equal(want, got, equal_nan=True)
    # The cases are there: cells hit twice or more in one draw, and cells
    # whose count of draws that hit them is 0, odd >= 3 and even >= 2.
    flat = np.where(good, cy * W + cx, H * W)
    hits = np.zeros(H * W + 1, int)
    for sel in perms:
        hits[np.unique(flat[sel])] += 1
    hits = hits[:-1]
    assert np.bincount(flat[perms[0]], minlength=H * W + 1)[:-1].max() >= 2
    assert (hits == 0).any()
    if subsample == 100:  # a full subsample hits every cell of the mesh in every draw
        assert set(np.unique(hits)) == {0, 10}
    else:
        assert ((hits % 2 == 1) & (hits >= 3)).any() and ((hits % 2 == 0) & (hits >= 2)).any()


def test_median_stack_draws_its_own_subsamples():
    """Without perms the port draws from a torch.Generator seeded with the
    seed: the same seed gives the same grid."""
    rng = np.random.default_rng(0)
    x, y = (torch.as_tensor(rng.integers(0, 8, 500)) for _ in range(2))
    z = torch.as_tensor(rng.standard_normal(500), dtype=torch.float32)
    good = torch.ones(500, dtype=torch.bool)
    a = tg._median_stack(x, y, z, good, (8, 8), 10, 250, seed=3)
    b = tg._median_stack(x, y, z, good, (8, 8), 10, 250, seed=3)
    assert torch.equal(a, b) and not torch.isnan(a).any()


def _stack(wds, Nx, Ny, subsample=100.0):
    js, _ = _setups(wds[0], Nx, Ny)
    ma, px, py, good = jax_bins(wds[0], js)
    H, W = js.XX.shape
    n_use = max(1, int(len(px) * subsample // 100))
    return np.asarray(jg._median_stack(jnp.asarray(np.clip(px, 0, W - 1), jnp.int32),
                                       jnp.asarray(np.clip(py, 0, H - 1), jnp.int32),
                                       jnp.asarray(ma[2], jnp.float32), jnp.asarray(good),
                                       jax.random.PRNGKey(0), (H, W), 10, n_use))


@pytest.mark.parametrize("subsample, hole", [(100.0, False), (10.0, False), (50.0, True)])
@pytest.mark.parametrize("Nx, Ny", [(32, 32), (24, 40)])
def test_idw_matches_jax(wds, subsample, hole, Nx, Ny):
    """IDW: the closed mask and the NaN pattern equal, the filled values
    within 1e-6 m (XLA and torch sum the 5x5 convolutions in other
    orders).  `hole`: a 16x16 hole that the closing leaves open."""
    Z = _stack(wds, Nx, Ny, subsample).copy()
    if hole:
        Z[4:20, 4:20] = np.nan
    want, wmask = ji.idw_interpolate(Z)
    got, gmask = ti.idw_interpolate(torch.as_tensor(Z))
    assert np.array_equal(wmask, gmask.numpy())
    assert np.array_equal(np.isnan(want), np.isnan(got.numpy()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6, equal_nan=True)
    assert np.isnan(Z).any() and (not hole or (wmask == 0).any())


def _coeffs(Irec: np.ndarray, nf: int) -> np.ndarray:
    """The coefficients behind a reconstruction (the DCT is orthonormal)."""
    H, W = Irec.shape
    return (ji._dct_matrix(H)[:nf] @ Irec.astype(np.float64) @ ji._dct_matrix(W)[:nf].T)


@pytest.mark.parametrize("Nx, Ny, nfreqs, iters", [(32, 32, 16, 60), (24, 40, 16, 100), (32, 32, 32, 80)])
def test_dct_matches_jax(wds, Nx, Ny, nfreqs, iters):
    """DCT fit with the JAX package's initial coefficients: the surface
    within 0.1% of Z's range at the cells with data and 1% in the holes
    (where the fit only extrapolates), the final loss within 1e-4
    relative.  (Rprop steps by sign(g), so ulp-level differences of g can
    flip single steps; the loss is convex, so both runs end near one
    minimiser.  chip_smoke.py phase G holds the card to the CPU by the
    same rule.)"""
    Z = _stack(wds, Nx, Ny, 50.0)
    want, wmask = ji.dct_interpolate(Z, nfreqs=nfreqs, max_iters=iters, seed=0)
    got, gmask = ti.dct_interpolate(torch.as_tensor(Z), nfreqs=nfreqs, max_iters=iters,
                                    x0=torch.as_tensor(jax_x0(0, nfreqs)))
    got = got.numpy()
    assert np.array_equal(wmask, gmask.numpy())
    obs = ~np.isnan(Z)
    zr = float(np.nanmax(Z) - np.nanmin(Z))
    diff = np.abs(got - want)
    print(f"DCT {Ny}x{Nx} nfreqs {nfreqs} {iters} iterations: max |port - JAX| {diff[obs].max():.3g} m at the "
          f"cells with data, {diff[~obs].max():.3g} m in the holes, Z range {zr:.3g} m")
    assert diff[obs].max() <= 1e-3 * zr and diff[~obs].max() <= 1e-2 * zr
    I = torch.as_tensor(np.nan_to_num(Z))
    m = torch.as_tensor(obs).float()
    lw = ti.dct_loss(torch.as_tensor(want), I, m, torch.as_tensor(_coeffs(want, nfreqs)), 8e-7)
    lg = ti.dct_loss(torch.as_tensor(got), I, m, torch.as_tensor(_coeffs(got, nfreqs)), 8e-7)
    assert abs(lg - lw) <= 1e-4 * abs(lw), (lg, lw)
    assert (~obs).any()


def test_dct_draws_its_own_x0():
    Z = np.full((16, 20), np.nan, np.float32)
    Z[::3, ::2] = 0.5
    a, _ = ti.dct_interpolate(torch.as_tensor(Z), nfreqs=8, max_iters=30, seed=5)
    b, _ = ti.dct_interpolate(torch.as_tensor(Z), nfreqs=8, max_iters=30, seed=5)
    assert torch.equal(a, b) and torch.isfinite(a).all()


def _spiky_cloud(seed: int, n: int = 4000, n_bad: int = 60):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-10, 10, n)
    y = rng.uniform(-10, 10, n)
    z = 0.05 * x - 0.03 * y + 0.01 * rng.standard_normal(n)
    bad = rng.choice(n, n_bad, replace=False)
    z[bad] += rng.choice([-1, 1], n_bad) * rng.uniform(1.5, 3.0, n_bad)
    return np.vstack([x, y, z]), bad


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_outlier_votes_match_jax(seed):
    """The keep votes equal the JAX package's, also where a cell's float32
    normal equations are singular: with seed 0 one cell's first round
    keeps a single point, the LU's second pivot vanishes in both packages
    (the port writes out the JAX package's pivoted LU, `solve3`), the
    plane is non-finite and the cell keeps all its points, two spikes
    among them.  Every other spike is dropped."""
    mesh, bad = _spiky_cloud(seed)
    pts = np.ascontiguousarray(mesh.T, np.float32)
    want = np.asarray(jo._vote_device(jnp.asarray(pts), jnp.float32(0.2)))
    got = to._vote_device(torch.as_tensor(pts), 0.2).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[bad].sum() == (2 if seed == 0 else 0)
    out = to.filter_mesh_outliers(torch.as_tensor(mesh), 0.2).numpy()
    np.testing.assert_array_equal(out, mesh[:, got])


def test_solve3_is_a_pivoted_lu():
    """solve3 agrees with torch.linalg.solve on well-conditioned systems
    (1e-4 relative, float32 with condition numbers below 1e3) and gives
    non-finite unknowns where a float32 pivot vanishes (a rank-1 system
    plus a regularisation that float32 loses, as in the singular cell)."""
    rng = np.random.default_rng(5)
    A = rng.standard_normal((200, 3, 3)) + 3 * np.eye(3)
    keep = np.linalg.cond(A) < 1e3
    A, b = torch.as_tensor(A[keep], dtype=torch.float32), torch.as_tensor(rng.standard_normal((keep.sum(), 3)),
                                                                          dtype=torch.float32)
    want = torch.linalg.solve(A, b[..., None])[..., 0]
    assert ((to.solve3(A, b) - want).abs() <= 1e-4 * want.abs().amax(-1, keepdim=True)).all()
    v = torch.tensor([9.991145, -8.883017, 1.0])
    S = (v[:, None] * v[None, :] + torch.eye(3) * 1e-6)[None]
    assert not torch.isfinite(to.solve3(S, (v * 0.753)[None])).all()


def test_outlier_votes_on_a_mesh_and_small_clouds(wds):
    js, ts = _setups(wds[0], 32, 32)
    ma, *_ = jax_bins(wds[0], js)
    want = jo.filter_mesh_outliers(ma, 0.05)
    got = to.filter_mesh_outliers(tg.align_mesh(tg.load_mesh(wds[0].path / "mesh_cam.xyzC", "cpu"), ts), 0.05)
    assert got.shape == want.shape and 0 < want.shape[1] < ma.shape[1]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    small = np.random.default_rng(0).standard_normal((3, 8))
    assert to.filter_mesh_outliers(torch.as_tensor(small)).shape == small.shape


FRAME_CASES = [
    ("DCT", False, 0), ("DCT", True, 3), ("IDW", False, 0), ("IDW", True, 0), ("IDW", False, 3),
    ("LinearND", False, 0), ("LinearND", True, 3),
]


@pytest.mark.parametrize("algorithm, with_mask, mf", FRAME_CASES)
def test_grid_frame_matches_jax(wds, algorithm, with_mask, mf):
    """A whole frame (subsample 50%, nfreqs 16, 80 iterations) with the
    JAX draws: the mask equal, the NaN pattern equal, Z within 0.1% of its
    range for DCT, 1e-6 m for IDW and 1e-9 m for LinearND (host scipy on
    float64 points that agree to 1e-14)."""
    js, ts = _setups(wds[0], 32, 32)
    user_mask = None
    if with_mask:
        user_mask = np.ones(js.XX.shape, np.float32)
        user_mask[5:12, 3:20] = 0
    cfg_kw = dict(algorithm=algorithm, subsample_percent=50.0, median_filter_size=mf, dct_nfreqs=16, dct_iters=80,
                  seed=1)
    want, wmask = jg.grid_frame(JaxWorkdir(wds[0].path), js, jg.GridConfig(**cfg_kw), user_mask=user_mask)
    npts = int(load_camera_mesh(wds[0].path / "mesh_cam.xyzC").shape[1])
    perms = torch.as_tensor(jax_perms(1, 10, npts, max(1, int(npts * 50.0 // 100))))
    got, gmask = tg.grid_frame(wds[0], ts, tg.GridConfig(**cfg_kw), user_mask=user_mask, device="cpu",
                               perms=perms, x0=torch.as_tensor(jax_x0(1, 16)))
    got, gmask = got.numpy(), gmask.numpy()
    assert got.dtype == want.dtype and gmask.dtype == np.float32
    assert np.array_equal(wmask, gmask)
    assert np.array_equal(np.isnan(want), np.isnan(got))
    assert np.isfinite(got).mean() > 0.5
    tol = {"DCT": 1e-3 * float(np.nanmax(want) - np.nanmin(want)), "IDW": 1e-6, "LinearND": 1e-9}[algorithm]
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, equal_nan=True)


@pytest.mark.parametrize("shape", [(1, 1), (64, 96)])
def test_png_gray_shape(tmp_path, shape):
    """The image push reads a frame's size from its PNG header: any 8-bit
    grayscale PNG (the port's codec, imageio's), nothing else."""
    import imageio.v3 as iio

    from wass_tpu_torch.io import png

    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    assert png.gray_shape(png.encode_gray(img)) == shape
    iio.imwrite(tmp_path / "a.png", img)
    assert png.gray_shape((tmp_path / "a.png").read_bytes()) == shape
    iio.imwrite(tmp_path / "rgb.png", np.stack([img] * 3, -1))
    with pytest.raises(ValueError, match="colour type 2"):
        png.gray_shape((tmp_path / "rgb.png").read_bytes())
    with pytest.raises(ValueError, match="not a PNG"):
        png.gray_shape(b"GIF89a" + bytes(30))


@pytest.mark.parametrize("algorithm", ["DCT", "IDW"])
def test_grid_frame_of_an_empty_mesh(tmp_path, algorithm):
    """A failed stereo frame leaves an empty mesh_cam.xyzC: the median stack
    is all NaN, DCT fits the regularizer alone (the JAX package's values,
    to 0.1% of their range), IDW leaves every cell NaN."""
    wd = write_grid_sequence(tmp_path, n_frames=1)[0]
    js, ts = _setups(wd, 16, 16)
    wd.save_mesh(np.zeros((0, 3)), np.eye(3), np.zeros(3))
    cfg_kw = dict(algorithm=algorithm, dct_nfreqs=8, dct_iters=30)
    want, wmask = jg.grid_frame(JaxWorkdir(wd.path), js, jg.GridConfig(**cfg_kw))
    got, gmask = tg.grid_frame(wd, ts, tg.GridConfig(**cfg_kw), device="cpu",
                               perms=torch.as_tensor(jax_perms(0, 10, 0, 1)), x0=torch.as_tensor(jax_x0(0, 8)))
    assert np.array_equal(wmask, gmask.numpy()) and np.array_equal(np.isnan(want), np.isnan(got.numpy()))
    if algorithm == "DCT":
        zr = float(np.nanmax(want) - np.nanmin(want))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3 * zr)
    else:
        assert np.isnan(want).all()
