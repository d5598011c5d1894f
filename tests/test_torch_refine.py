"""The grid's photo-consistency refinement (--refine): the port's
grid/variational.py against the JAX package's wass_tpu/grid/variational.py,
and both consoles' `--action grid --refine`.

Tolerances and why:
- the antialiased down-resize (F.interpolate) and the up-resize matrices
  against jax.image.resize: within 3e-6 (float32 sums in other orders);
- one step's gradient against jax.grad: relative 1e-3 on the cells whose
  |g| is above 1e-3 of the largest (below that the gradient is float noise
  of the mean's sums, different in the two packages);
- Adam turns noise into steps: where a cell's gradient is at the noise
  level its first steps move it by about lr whatever the gradient's size,
  so two packages' refined Z could differ by up to lr x steps there.  The
  scenes here have no such cell (the data term covers the mask, the
  smoothness term acts on every cell): the short run (20 steps, lr 5e-3)
  is held within 1e-5 m (measured 1e-7), the consoles' 400-step runs
  (lr 1e-3) within 0.1% of Z's range, the DCT fit's tolerance of
  tests/test_torch_gridsurface_cli.py (measured 5e-5 mm against a mean
  move of 175 mm), the NaN cells equal;
- the JAX test's property (tests/test_grid_post.py, 600 steps): the
  error halves, on the port.
"""

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from wass_tpu.cli.gridsurface import cli as jax_cli
from wass_tpu.grid import variational as jv
from wass_tpu.ops.sampling import bilinear_sample as jbilinear
from wass_tpu_torch.cli.gridsurface import main
from wass_tpu_torch.grid import variational as tv

from torch_grid_data import AREA, BASELINE, use_jax_draws, write_grid_sequence


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _scene(H=48, W=48, holes=False):
    """The JAX test's flat surface under two cameras with an analytic
    texture, Z started from a smooth perturbation (plane frame = alignment
    frame: Rpl = I, Tpl = 0, baseline 1)."""
    XX, YY = np.meshgrid(np.linspace(-2.0, 2.0, W), np.linspace(-2.0, 2.0, H))

    def tex(x, y):
        return 127.0 + 60.0 * np.sin(2.1 * x) * np.cos(1.7 * y) + 40.0 * np.sin(3.3 * x + 2.9 * y)

    f, cx, cy, depth, n = 60.0, 32.0, 32.0, 5.0, 64
    K = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1.0]])

    def render(tx):
        u, v = np.meshgrid(np.arange(n, dtype=float), np.arange(n, dtype=float))
        return tex((u - cx) * depth / f - tx, (v - cy) * depth / f)

    b = 0.4
    mask = np.ones((H, W), np.float32)
    if holes:
        mask[:7, :9] = 0.0
        mask[30:, 40:] = 0.0
    Z = 0.25 * np.sin(1.5 * XX) * np.cos(1.2 * YY)
    return dict(Z=Z, I0=render(0.0), I1=render(b), P0=K @ np.hstack([np.eye(3), [[0.0], [0.0], [5.0]]]),
                P1=K @ np.hstack([np.eye(3), [[b], [0.0], [5.0]]]), XX=XX, YY=YY, mask=mask)


def _args(s):
    return (s["I0"], s["I1"], s["P0"], s["P1"], np.eye(3), np.zeros(3), s["XX"], s["YY"], 1.0, s["mask"])


@pytest.mark.parametrize("shape,coarse", [((48, 48), (24, 24)), ((256, 256), (128, 128)), ((33, 50), (16, 25))])
def test_resizes_match_jax(rng, shape, coarse):
    a = rng.normal(size=shape).astype(np.float32)
    down = tv.down_resize(torch.from_numpy(a), coarse).numpy()
    np.testing.assert_allclose(down, np.asarray(jax.image.resize(jnp.asarray(a), coarse, "bilinear")), atol=3e-6)
    s = rng.normal(size=coarse).astype(np.float32)
    up = (torch.from_numpy(tv.up_matrix(shape[0], coarse[0])) @ torch.from_numpy(s)
          @ torch.from_numpy(tv.up_matrix(shape[1], coarse[1])).T).numpy()
    np.testing.assert_allclose(up, np.asarray(jax.image.resize(jnp.asarray(s), shape, "bilinear")), atol=3e-6)


def _jax_grad(s, Zc, alpha):
    """jax.grad of the JAX function's loss (wass_tpu/grid/variational.py:97-103)."""
    H, W = s["Z"].shape
    kx, ky = jv._dog_kernels()
    Xp, Yp = jnp.asarray(s["XX"], jnp.float32), jnp.asarray(s["YY"], jnp.float32)
    m = jnp.asarray(s["mask"])
    P0, P1 = jnp.asarray(s["P0"], jnp.float32), jnp.asarray(s["P1"], jnp.float32)

    def sample(img, P, pc):
        uvw = P[:, :3] @ pc + P[:, 3:4]
        uv = uvw[:2] / jnp.maximum(uvw[2], 1e-6)
        return jbilinear(img, uv[0].reshape(H, W), uv[1].reshape(H, W))

    def loss(Zc):
        Zfull = jax.image.resize(Zc, (H, W), "bilinear")
        pc = jnp.stack([Xp.ravel(), Yp.ravel(), -Zfull.ravel()])
        s0 = sample(jnp.asarray(s["I0"], jnp.float32), P0, pc) * m / 255.0
        s1 = sample(jnp.asarray(s["I1"], jnp.float32), P1, pc) * m / 255.0
        data = jnp.mean(jnp.square(s0 - s1))
        smooth = jnp.mean(jnp.square(jv._conv2(Zfull, kx)) + jnp.square(jv._conv2(Zfull, ky)))
        return data + alpha * smooth

    return np.asarray(jax.grad(loss)(jnp.asarray(Zc)))


@pytest.mark.parametrize("holes", [False, True])
def test_one_step_gradient_matches_jax_grad(holes):
    s = _scene(holes=holes)
    Zc = np.asarray(jax.image.resize(jnp.asarray(s["Z"], jnp.float32), (24, 24), "bilinear"))
    ref = tv._Refiner((48, 48), (64, 64), 2, 0.05, 5e-3, 1.0, torch.device("cpu"))
    camT = np.concatenate([np.eye(3), np.zeros((3, 1))], 1)
    ref.load(*(torch.as_tensor(np.asarray(a, np.float32))
               for a in (Zc, s["I0"], s["I1"], s["P0"], s["P1"], camT, s["XX"], s["YY"], s["mask"])))
    (g,) = torch.autograd.grad(ref.loss(ref.Zc), ref.Zc)
    g, gj = g.numpy(), _jax_grad(s, Zc, 0.05)
    big = np.abs(gj) > 1e-3 * np.abs(gj).max()
    assert big.mean() > 0.9
    np.testing.assert_allclose(g[big], gj[big], rtol=1e-3)


def test_short_run_matches_jax():
    s = _scene(holes=True)
    kw = dict(max_iters=20, alpha=0.05, lr=5e-3)
    j = np.asarray(jv.variational_refine(jnp.asarray(s["Z"], jnp.float32), *_args(s), **kw))
    stats = {}
    t = tv.variational_refine(torch.as_tensor(s["Z"], dtype=torch.float32), *_args(s), stats=stats, **kw).numpy()
    assert np.array_equal(np.isnan(t), s["mask"] == 0) and np.array_equal(np.isnan(t), np.isnan(j))
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-5, equal_nan=True)
    assert stats["loss_last"] < stats["loss_first"]


def test_refinement_halves_the_error():
    """tests/test_grid_post.py's property on the port (600 steps)."""
    s = _scene()
    Zr = tv.variational_refine(torch.as_tensor(s["Z"], dtype=torch.float32), *_args(s), max_iters=600, alpha=0.05,
                               lr=5e-3).numpy()
    inner = (slice(6, -6), slice(6, -6))
    assert np.isfinite(Zr).all()
    assert np.abs(Zr)[inner].mean() < 0.5 * np.abs(s["Z"])[inner].mean()


def test_graph_needs_the_card():
    s = _scene()
    with pytest.raises(ValueError, match="CUDA"):
        tv.variational_refine(torch.as_tensor(s["Z"], dtype=torch.float32), *_args(s), max_iters=1, use_graph=True)


N = 32
SETUP = ["--action", "setup", "--baseline", str(BASELINE), "--area_center", AREA[0], "--area_size", AREA[1],
         "-N", str(N), "--fps", "4"]


def test_refine_console_matches_jax(tmp_path, monkeypatch):
    """Both consoles' --action grid --refine on the same workdirs, the port
    drawing the JAX package's subsamples and DCT start."""
    seq = tmp_path / "seq"
    write_grid_sequence(seq, n_frames=2)
    use_jax_draws(monkeypatch)
    jd, pd, plain = tmp_path / "jax", tmp_path / "port", tmp_path / "port_plain"
    runner = CliRunner()
    grid = ["--action", "grid", "--no-images"]
    for a in (SETUP, grid + ["--refine"]):
        r = runner.invoke(jax_cli, [str(seq), str(jd), *a])
        assert r.exit_code == 0, r.output
        assert main([str(seq), str(pd), *a, "--device", "cpu"]) == 0
    for a in (SETUP, grid):
        assert main([str(seq), str(plain), *a, "--device", "cpu"]) == 0
    with h5py.File(jd / "gridded.nc", "r") as fj, h5py.File(pd / "gridded.nc", "r") as fp, \
            h5py.File(plain / "gridded.nc", "r") as f0:
        Zj, Zp, Z0 = fj["Z"][...], fp["Z"][...], f0["Z"][...]
    assert Zj.shape == Zp.shape == (2, N, N)
    assert np.array_equal(np.isnan(Zj), np.isnan(Zp)) and np.array_equal(np.isnan(Zp), np.isnan(Z0))
    assert np.isfinite(Zp).mean() > 0.3
    moved = np.nanmean(np.abs(Zp - Z0))
    assert moved > 1.0  # mm: the refinement ran
    np.testing.assert_allclose(Zp, Zj, rtol=0, atol=1e-3 * np.nanmax(np.abs(Zj)), equal_nan=True)
