"""Port parity: geometry, epipolar errors, bundle adjustment, the Sampson
polish and the pooled autocalibration (wass_tpu_torch/core, calib)
against the JAX package, on the same inputs and the same RANSAC draws."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from wass_tpu.calib import autocalibrate as jauto
from wass_tpu.calib import ba as jba
from wass_tpu.core import epipolar as jepi
from wass_tpu.core import geometry as jgeom
from wass_tpu_torch.calib import autocalibrate as tauto
from wass_tpu_torch.calib import ba as tba
from wass_tpu_torch.core import epipolar as tepi
from wass_tpu_torch.core import geometry as tgeom
from wass_tpu_torch.match.pipeline import ransac_capacity


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads for this module (the test workers share the
    host's cores), restored after it: other modules' float checks depend
    on the default count."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a, dtype=np.float32):
    return torch.from_numpy(np.array(a, dtype=dtype))


def make_two_view(rng, n=600, noise=2e-4, planar=False):
    """tests/test_calib.py:16-33."""
    R, _ = cv2.Rodrigues(np.array([0.02, -0.25, 0.015]))
    T = np.array([-1.0, 0.02, 0.06])
    T = T / np.linalg.norm(T)
    if planar:
        x = rng.uniform(-4, 4, n)
        y = rng.uniform(-4, 4, n)
        z = 12 + 0.5 * x - 0.8 * y + rng.standard_normal(n) * 0.1
        pts = np.stack([x, y, z], 1)
    else:
        pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-4, 4, n), rng.uniform(8, 25, n)], 1)
    p0 = pts[:, :2] / pts[:, 2:]
    x1 = pts @ R.T + T
    p1 = x1[:, :2] / x1[:, 2:]
    p0 = p0 + rng.standard_normal(p0.shape) * noise
    p1 = p1 + rng.standard_normal(p1.shape) * noise
    return R, T, pts, p0, p1


# --- geometry and epipolar errors ------------------------------------------------


def _close(a, b):
    """1e-6 relative, element by element and to the largest value."""
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=1e-6, atol=1e-6 * max(np.abs(b).max(), 1e-30))


def test_rotation_parametrisations(rng):
    r = (rng.normal(size=(20, 3)) * 0.7).astype(np.float32)
    r[0] = 0.0
    r[1] = 1e-6
    _close(tgeom.skew(_t(r)), jgeom.skew(jnp.asarray(r)))
    R = tgeom.rodrigues(_t(r))
    _close(R, jgeom.rodrigues(jnp.asarray(r)))
    Rn = R.numpy()
    _close(tgeom.inv_rodrigues(_t(Rn)), jgeom.inv_rodrigues(jnp.asarray(Rn)))
    q = tgeom.rot_to_quat(_t(Rn))
    _close(q, jgeom.rot_to_quat(jnp.asarray(Rn)))
    _close(tgeom.quat_to_rot(q), jgeom.quat_to_rot(jnp.asarray(q.numpy())))
    T = rng.normal(size=(20, 3, 1)).astype(np.float32)
    for a, b in zip(tgeom.invert_rt(_t(Rn), _t(T)), jgeom.invert_rt(jnp.asarray(Rn), jnp.asarray(T))):
        _close(a, b)


@pytest.mark.parametrize("at", ["zero", "random"])
def test_rodrigues_jacobian(rng, at):
    """jacfwd through the double-where: finite and equal to JAX's at the
    identity (the BA linearization point) and at a random vector."""
    r = np.zeros(3, np.float32) if at == "zero" else (rng.normal(size=3) * 0.4).astype(np.float32)
    Jt = jacfwd(tgeom.rodrigues)(_t(r)).numpy()
    Jj = np.asarray(jax.jacfwd(jgeom.rodrigues)(jnp.asarray(r)))
    assert np.isfinite(Jt).all()
    _close(Jt, Jj)


def test_epipolar_errors(rng):
    """A random F and random correspondences (no residual near zero, where
    x1^T F x0 cancels and any change of summation order shows): 1e-6
    relative; the statistics with and without a mask."""
    F = rng.normal(size=(3, 3)).astype(np.float32)
    uv0, uv1 = (rng.normal(size=(300, 2)).astype(np.float32) for _ in range(2))
    mask = rng.random(300) < 0.8
    for name in ("sampson_distance", "symmetric_epipolar_distance"):
        _close(getattr(tepi, name)(_t(F), _t(uv0), _t(uv1)),
               getattr(jepi, name)(jnp.asarray(F), jnp.asarray(uv0), jnp.asarray(uv1)))
    for m in (None, mask):
        a = tepi.epipolar_error_stats(_t(F), _t(uv0), _t(uv1), None if m is None else torch.from_numpy(m))
        b = jepi.epipolar_error_stats(jnp.asarray(F), jnp.asarray(uv0), jnp.asarray(uv1),
                                      None if m is None else jnp.asarray(m))
        for x, y in zip(a, b):
            np.testing.assert_allclose(float(x), float(y), rtol=1e-6)
    R, T, pts, p0, p1 = make_two_view(rng, n=300)
    K = np.array([[800.0, 0, 320], [0, 800, 240], [0, 0, 1]])
    a = tepi.structure_error_stats(_t(pts), _t(uv0), _t(uv1), _t(R), _t(T), _t(K), _t(K), torch.from_numpy(mask))
    b = jepi.structure_error_stats(*(jnp.asarray(v, jnp.float32) for v in (pts, uv0, uv1, R, T, K, K)), jnp.asarray(mask))
    for x, y in zip(a, b):
        np.testing.assert_allclose(float(x), float(y), rtol=1e-6)


# --- bundle adjustment and the Sampson polish ----------------------------------------


def _ba_case(rng, case):
    """tests/test_calib.py:36-65: the perturbed start, and the padded pool."""
    if case == "converges":
        R, T, pts, p0, p1 = make_two_view(rng)
        Rp, _ = cv2.Rodrigues(cv2.Rodrigues(R)[0].ravel() + np.array([2e-3, -1.5e-3, 1e-3]))
        Tp = T + np.array([3e-3, -2e-3, 1e-3])
        Xp = pts + rng.standard_normal(pts.shape) * 0.05
        return R, T, (Rp, Tp, Xp, p0, p1, np.ones(len(pts), bool))
    R, T, pts, p0, p1 = make_two_view(rng, n=128)
    pad = 64
    p0p = np.concatenate([p0, rng.standard_normal((pad, 2)) * 10])
    p1p = np.concatenate([p1, rng.standard_normal((pad, 2)) * 10])
    Xp = np.concatenate([pts, np.ones((pad, 3))])
    mask = np.concatenate([np.ones(len(pts), bool), np.zeros(pad, bool)])
    return R, T, (R, T, Xp, p0p, p1p, mask)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", ["converges", "padded"])
def test_lm_refine_two_view_matches_jax(rng, case, dtype):
    """The JAX tests' gates, and both loops stopped by the LM rule before
    the cap.  float64 (the JAX function under jax.enable_x64): the same
    step count, R and T within 1e-10 of the JAX package's.

    float32: R and T's direction within 1e-5 (|T| is the gauge of two-view
    BA: the points and T scale together, so its length is set by the
    damping's path and is compared to 1e-4), and the step counts within 8.
    In float32 an accepted step lowers the cost by at least an ulp, so the
    loop stops after ~21 rejected steps once the cost stops falling (lambda
    from ~1e-9 up to 1e6), and which step first fails to lower the cost by
    an ulp depends on the sums' order: the JAX package's own jitted and
    op-by-op runs differ there (24 and 27 steps on "padded").  In float64
    the relative-decrease rule (1e-10) stops both loops after the same
    step.  Both counts are printed."""
    R, T, args = _ba_case(rng, case)
    arrs = [np.asarray(a, dtype) for a in args[:5]]
    if dtype == "float64":
        with jax.enable_x64():
            rj = jba.lm_refine_two_view(*(jnp.asarray(a) for a in arrs), jnp.asarray(args[5]))
    else:
        rj = jba.lm_refine_two_view(*(jnp.asarray(a) for a in arrs), jnp.asarray(args[5]))
    rt = tba.lm_refine_two_view(*(_t(a, dtype) for a in arrs), torch.from_numpy(args[5]))
    print(f"{case} {dtype}: LM steps jax {int(rj.n_iters)} port {rt.n_iters}; "
          f"cost {float(rj.final_cost):.4g} {float(rt.final_cost):.4g}")
    assert rt.n_iters < 50 and int(rj.n_iters) < 50
    Tt, Tj = rt.T.numpy(), np.asarray(rj.T)
    if dtype == "float64":
        assert rt.n_iters == int(rj.n_iters)
        np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=1e-10)
        np.testing.assert_allclose(Tt, Tj, atol=1e-10)
    else:
        assert abs(rt.n_iters - int(rj.n_iters)) <= 8
        np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=1e-5)
        np.testing.assert_allclose(Tt / np.linalg.norm(Tt), Tj / np.linalg.norm(Tj), atol=1e-5)
        np.testing.assert_allclose(Tt, Tj, atol=1e-4)
    if case == "converges":
        assert float(rt.final_cost) < float(rt.initial_cost) * 0.05
        Tr = Tt / np.linalg.norm(Tt)
        assert np.abs(rt.R.numpy() - R).max() < 5e-4 and np.abs(Tr - T).max() < 2e-3
    else:
        assert np.abs(rt.R.numpy() - R).max() < 1e-3


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("robust", [None, 1e-3])
def test_lm_refine_pose_epipolar_matches_jax(rng, robust, dtype):
    """A perturbed pose polished over noisy correspondences with 5% gross
    outliers, without and with the redescending transform: R and T within
    1e-5 (float32) and 1e-10 (float64, the JAX function under
    jax.enable_x64) of the JAX package's.  (The JAX function returns no
    step count; the port's stops by the LM rule as the two-view BA's
    above.)"""
    R, T, pts, p0, p1 = make_two_view(rng, n=400, noise=3e-4, planar=True)
    out = rng.random(len(p0)) < 0.05
    p1[out] += rng.uniform(-0.02, 0.02, (int(out.sum()), 2))
    dR, _ = cv2.Rodrigues(np.array([1e-3, -2e-3, 5e-4]))
    R0 = (dR @ R).astype(np.float32)
    T0 = (T + np.array([4e-3, -3e-3, 2e-3])).astype(np.float32)
    mask = np.ones(len(p0), bool)
    mask[::17] = False
    args = [np.asarray(a, np.float32).astype(dtype) for a in (R0, T0, p0, p1)]
    if dtype == "float64":
        with jax.enable_x64():
            rj = jba.lm_refine_pose_epipolar(*(jnp.asarray(a) for a in args), jnp.asarray(mask), robust_scale=robust)
    else:
        rj = jba.lm_refine_pose_epipolar(*(jnp.asarray(a) for a in args), jnp.asarray(mask), robust_scale=robust)
    rt = tba.lm_refine_pose_epipolar(*(_t(a, dtype) for a in args), torch.from_numpy(mask), robust_scale=robust)
    print(f"robust {robust} {dtype}: port LM steps {rt.n_iters}, rms {float(rj.final_rms):.4g} {float(rt.final_rms):.4g}")
    tol = 1e-10 if dtype == "float64" else 1e-5
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=tol)
    np.testing.assert_allclose(rt.T.numpy(), np.asarray(rj.T), atol=tol)
    np.testing.assert_allclose(float(rt.final_rms), float(rj.final_rms), rtol=1e-3)
    assert float(rt.final_rms) < float(rt.initial_rms) and rt.n_iters < 60


def test_polish_pose_f64_identical(rng):
    """The host float64 polish is a copy: bit-equal, and the JAX test's gates."""
    R, T, pts, p0, p1 = make_two_view(rng, n=2000, noise=3e-6)
    dR, _ = cv2.Rodrigues(np.array([4e-4, -3e-4, 2e-4]))
    T0 = T + np.array([1e-3, -8e-4, 5e-4])
    args = (dR @ R, T0 / np.linalg.norm(T0), p0, p1, np.ones(len(p0)))
    for a, b in zip(tba.polish_pose_f64(*args), jba.polish_pose_f64(*args)):
        np.testing.assert_array_equal(a, b)
    Rr, Tr, rms0, rms1 = tba.polish_pose_f64(*args)
    assert rms1 <= rms0 and np.abs(Rr - R).max() < 3e-5 and np.abs(Tr - T).max() < 3e-4


# --- the pooled autocalibration ----------------------------------------------------


def _pool(rng, case):
    """tests/test_calib.py:84-128's pools in pixels (K = 1400 px at 2048x1536)."""
    K = np.array([[1400.0, 0, 1024], [0, 1400, 768], [0, 0, 1]])
    if case == "gates":
        R, T, pts, p0n, p1n = make_two_view(rng, n=3000, noise=0.4 / 1400, planar=True)
    else:
        R, T, pts, p0n, p1n = make_two_view(rng, n=2500, noise=0.01 / 1400, planar=True)
        out = rng.random(len(p0n)) < 0.03
        p1n[out] += rng.uniform(-0.02, 0.02, (int(out.sum()), 2))
    uv0 = p0n * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
    uv1 = p1n * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
    return K, R, T, uv0, uv1


def autocal_draws(seed: int, n_hyp: int, n_matches: int) -> tauto.AutocalDraws:
    """autocalibrate_pooled's RANSAC samples: relative_pose_ransac's draws
    from PRNGKey(cfg.seed) over the padded pool."""
    N = ransac_capacity(n_matches)
    k_h, k_e = jax.random.split(jax.random.PRNGKey(seed))
    idx_h = jax.vmap(lambda k: jax.random.randint(k, (4,), 0, N))(jax.random.split(k_h, n_hyp))
    idx_e = jax.vmap(lambda k: jax.random.randint(k, (8,), 0, N))(jax.random.split(k_e, n_hyp // 4))
    return tauto.AutocalDraws(_t(idx_h, np.int64), _t(idx_e, np.int64))


@pytest.mark.parametrize("case", ["gates", "f64_precision"])
def test_autocalibrate_pooled_matches_jax(rng, case):
    """R within 2e-5 of the JAX package's, T within 2e-5 on the LK-level
    pool and 5e-5 on the 0.4 px pool, and the JAX tests' gates.

    On the 0.4 px pool the pose's cost is flat along T at the level of
    its error to the truth (printed): the five Cauchy polish rounds, each
    re-measuring its scale, carry a difference of a few 1e-6 in the BA
    results into a few 1e-5 of T."""
    K, R, T, uv0, uv1 = _pool(rng, case)
    jcfg = jauto.AutocalConfig(max_points=4096)
    rj = jauto.autocalibrate_pooled(uv0, uv1, K, K, jcfg)
    cfg = tauto.AutocalConfig(max_points=4096)
    rt = tauto.autocalibrate_pooled(uv0, uv1, K, K, cfg, device="cpu",
                                    draws=autocal_draws(cfg.seed, cfg.ransac_hypotheses, len(uv0)))
    print(f"{case}: inliers {rj.n_inliers} {rt.n_inliers}; median px {rj.epi_med_after:.5g} {rt.epi_med_after:.5g}; "
          f"|dR| {np.abs(rj.R - R).max():.3g} {np.abs(rt.R - R).max():.3g}, "
          f"|dT| {np.abs(rj.T.ravel() - T).max():.3g} {np.abs(rt.T.ravel() - T).max():.3g}")
    np.testing.assert_allclose(rt.R, rj.R, atol=2e-5)
    np.testing.assert_allclose(rt.T, rj.T, atol=2e-5 if case == "f64_precision" else 5e-5)
    assert rt.improved == rj.improved
    if case == "gates":
        assert np.abs(rt.R - R).max() < 5e-3 and np.abs(rt.T.ravel() - T).max() < 2e-2
        assert rt.epi_med_after <= rt.epi_med_before + 1e-4
    else:
        assert np.abs(rt.R - R).max() < 1e-4 and np.abs(rt.T.ravel() - T).max() < 1e-3


def test_pixel_homography_identical(rng):
    uv0 = rng.uniform(0, 500, (80, 2))
    uv1 = uv0 @ np.array([[1.01, 0.02], [-0.01, 0.99]]) + [3.0, -2.0] + rng.normal(0, 0.1, uv0.shape)
    np.testing.assert_array_equal(tauto._pixel_homography(uv0, uv1), jauto._pixel_homography(uv0, uv1))
    assert tauto._pixel_homography(uv0[:3], uv1[:3]) is None
