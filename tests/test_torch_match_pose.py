"""Port parity: relative-pose RANSAC, essential RANSAC and the whole
match stage (wass_tpu_torch/match/{ransac,pose,pipeline}.py) against the
JAX package, with the JAX package's random draws handed to the port (the
JAX package draws inside its functions from jax.random keys; these tests
make the same split / uniform / randint calls on the same keys)."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wass_tpu.match.pipeline as j_pipeline
import wass_tpu_torch.match.pipeline as t_pipeline
from wass_tpu.match.pipeline import MatchConfig as JMatchConfig
from wass_tpu.match.pipeline import match_frame as j_match_frame
from wass_tpu.match.pose import relative_pose_ransac as j_rel_pose
from wass_tpu.match.ransac import essential_ransac as j_ess_ransac
from wass_tpu.match.ransac import recover_pose as j_recover_pose
from wass_tpu.testing import make_scene
from wass_tpu_torch.match.features import FeatureSet
from wass_tpu_torch.match.pipeline import MatchConfig, MatchDraws, match_frame, ransac_capacity
from wass_tpu_torch.match.pose import relative_pose_ransac
from wass_tpu_torch.match.ransac import essential_ransac, recover_pose


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads for this module (the test workers share the
    host's cores), restored after it: other modules' float checks depend
    on the default count."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype))


def round_uniforms(key, rounds: int, C: int) -> np.ndarray:
    """gt_match's draws: round r splits the key and draws uniform(sub, (C,))."""
    out = []
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(sub, (C,))))
    return np.stack(out)


def pose_draws(key, n_hyp: int, N: int):
    """relative_pose_ransac's samples: (n_hyp, 4) and (n_hyp // 4, 8) randint(0, N)."""
    k_h, k_e = jax.random.split(key)
    idx_h = jax.vmap(lambda k: jax.random.randint(k, (4,), 0, N))(jax.random.split(k_h, n_hyp))
    idx_e = jax.vmap(lambda k: jax.random.randint(k, (8,), 0, N))(jax.random.split(k_e, n_hyp // 4))
    return _t(idx_h, np.int64), _t(idx_e, np.int64)


# --- RANSAC and pose -----------------------------------------------------------


def _correspondences(rng, n=200, outliers=50):
    """tests/test_match.py:82-91."""
    R, _ = cv2.Rodrigues(np.array([0.03, -0.28, 0.02]))
    T = np.array([-1.0, 0.01, 0.05])
    T = T / np.linalg.norm(T)
    pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-4, 4, n), rng.uniform(8, 25, n)], 1)
    p0 = pts[:, :2] / pts[:, 2:]
    x1 = pts @ R.T + T
    p1 = x1[:, :2] / x1[:, 2:]
    p1[:outliers] = rng.uniform(-0.4, 0.4, (outliers, 2))
    return R, T, p0.astype(np.float32), p1.astype(np.float32), outliers


def _planar(rng, n=600, noise=3e-4):
    """tests/test_calib.py:16-33 (planar) with tests/test_calib.py:71-73's outliers."""
    R, _ = cv2.Rodrigues(np.array([0.02, -0.25, 0.015]))
    T = np.array([-1.0, 0.02, 0.06])
    T = T / np.linalg.norm(T)
    x = rng.uniform(-4, 4, n)
    y = rng.uniform(-4, 4, n)
    z = 12 + 0.5 * x - 0.8 * y + rng.standard_normal(n) * 0.1
    pts = np.stack([x, y, z], 1)
    p0 = pts[:, :2] / pts[:, 2:]
    x1 = pts @ R.T + T
    p1 = x1[:, :2] / x1[:, 2:]
    p0 = p0 + rng.standard_normal(p0.shape) * noise
    p1 = p1 + rng.standard_normal(p1.shape) * noise
    out = rng.random(len(p0)) < 0.2
    p1[out] = rng.uniform(-0.4, 0.4, (out.sum(), 2))
    return R, T, p0.astype(np.float32), p1.astype(np.float32)


def _as(dtype, *arrays):
    return [np.asarray(a, dtype) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_essential_ransac_and_recover_pose_match_jax(rng, dtype):
    """The JAX test's scene and key: the same inliers and the JAX test's
    gates.  float64 (the JAX function under jax.enable_x64, whose draws
    are then int64 ones): R and T within 1e-9 of the JAX package's.

    float32: R within 1e-4 and T within 5e-4.  T is the left null vector
    of E, itself the null vector of the 200-row refit system, which float32
    does not determine to 1e-4: the JAX package's own float32 result lies
    ~2e-4 from its float64 result (printed), and jaxlib's float32
    eigen-solver and the port's (a float64 solve, rounded) differ there in
    the fourth digit of E and T."""
    R, T, p0, p1, n_out = _correspondences(rng)
    p0, p1 = _as(dtype, p0, p1)
    key = jax.random.PRNGKey(1)
    N = len(p0)
    valid = np.ones(N, bool)

    def jax_pose():
        idx = jax.vmap(lambda k: jax.random.randint(k, (8,), 0, N))(jax.random.split(key, 1024))
        er = j_ess_ransac(jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(valid), key, threshold=2.0 / 1000.0)
        return np.asarray(idx), er, j_recover_pose(er.E, jnp.asarray(p0), jnp.asarray(p1), er.inliers)

    if dtype == "float64":
        with jax.enable_x64():
            idx, er_j, pose_j = jax_pose()
    else:
        idx, er_j, pose_j = jax_pose()
    er_t = essential_ransac(_t(p0), _t(p1), _t(valid), _t(idx, np.int64), threshold=2.0 / 1000.0)
    np.testing.assert_array_equal(er_t.inliers.numpy(), np.asarray(er_j.inliers))
    assert int(er_t.n_inliers) > len(p0) - n_out - 15
    pose_t = recover_pose(er_t.E, _t(p0), _t(p1), er_t.inliers)
    print(f"{dtype}: |T - truth|: jax {np.abs(np.asarray(pose_j.T) - T).max():.3g} "
          f"port {np.abs(pose_t.T.numpy() - T).max():.3g}")
    if dtype == "float64":
        np.testing.assert_allclose(pose_t.R.numpy(), np.asarray(pose_j.R), atol=1e-9)
        np.testing.assert_allclose(pose_t.T.numpy(), np.asarray(pose_j.T), atol=1e-9)
    else:
        with jax.enable_x64():
            p64 = _as(np.float64, p0, p1)
            er64 = j_ess_ransac(*(jnp.asarray(a) for a in p64), jnp.asarray(valid), key, threshold=2.0 / 1000.0)
            T64 = np.asarray(j_recover_pose(er64.E, *(jnp.asarray(a) for a in p64), er64.inliers).T)
        print(f"the JAX package's float32 T against its float64 T: {np.abs(np.asarray(pose_j.T) - T64).max():.3g}")
        np.testing.assert_allclose(pose_t.R.numpy(), np.asarray(pose_j.R), atol=1e-4)
        np.testing.assert_allclose(pose_t.T.numpy(), np.asarray(pose_j.T), atol=5e-4)
    assert np.abs(pose_t.R.numpy() - R).max() < 5e-3
    assert np.abs(pose_t.T.numpy() - T).max() < 2e-2


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_relative_pose_ransac_matches_jax(rng, dtype):
    """The planar scene of tests/test_calib.py's pose test, with its key:
    R and T within 1e-4 (float32) and 1e-9 (float64, the JAX function under
    jax.enable_x64 with its int64 draws), inlier masks >= 99% equal, and in
    float32 the JAX test's gates (the float64 draws are other samples,
    whose winner both packages place 0.0203 from the truth in T, printed).
    On this scene the GN polish keeps no step (each
    lowers the chirality inlier count), so the pose is the winning RANSAC
    candidate itself: the hypotheses' float64 eigen-solve
    (match/ransac.py) is what makes the port pick the candidate the JAX
    package picks in float32 (with float32 solves the two libraries'
    roundings picked another of the near-tied candidates, outside the JAX
    test's T gate)."""
    R, T, p0, p1 = _planar(rng)
    p0, p1 = _as(dtype, p0, p1)
    key = jax.random.PRNGKey(2)
    N = len(p0)
    valid = np.ones(N, bool)

    def jax_pose():
        rp = j_rel_pose(jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(valid), key, threshold=1.5 / 1000.0)
        return rp, pose_draws(key, 512, N)

    if dtype == "float64":
        with jax.enable_x64():
            rp_j, (idx_h, idx_e) = jax_pose()
    else:
        rp_j, (idx_h, idx_e) = jax_pose()
    rp_t = relative_pose_ransac(_t(p0), _t(p1), _t(valid), idx_h, idx_e, threshold=1.5 / 1000.0)
    print(f"{dtype}: inliers jax {int(rp_j.n_inliers)} port {int(rp_t.n_inliers)}")
    tol = 1e-9 if dtype == "float64" else 1e-4
    np.testing.assert_allclose(rp_t.R.numpy(), np.asarray(rp_j.R), atol=tol)
    np.testing.assert_allclose(rp_t.T.numpy(), np.asarray(rp_j.T), atol=tol)
    assert (rp_t.inliers.numpy() == np.asarray(rp_j.inliers)).mean() >= 0.99
    assert int(rp_t.n_inliers) > 0.6 * N
    print(f"|dR|, |dT| to the truth: {np.abs(rp_t.R.numpy() - R).max():.3g} {np.abs(rp_t.T.numpy() - T).max():.3g}")
    if dtype == "float32":  # the JAX test's gates, on its float32 draws
        assert np.abs(rp_t.R.numpy() - R).max() < 5e-3
        assert np.abs(rp_t.T.numpy() - T).max() < 2e-2


# --- the frame stage -------------------------------------------------------------


@pytest.mark.parametrize("features", ["jax", "port"])
def test_match_frame_matches_jax(monkeypatch, features):
    """make_scene(seed=3, 512x384) with tests/test_match.py:110's config
    and the JAX draws of cfg.seed, and the JAX test's gates.

    "jax": the port's stage runs on the JAX package's FeatureSets, so the
    rounds, LK, pose RANSAC and the statistics see the same inputs: the
    same matches at every step, R and T within 1e-4, epi_avg within 1e-3
    px.  "port": the port's own features.  The scale space sums its wide
    blurs in another order than XLA's convolution, and at the coarse
    scales (sigma up to 21.6, the response scaled by sigma^4) both
    packages' responses carry float32 rounding that moves features across
    the threshold and the 3x3x3 maximum (at 3 MP the port's responses are
    the closer to a float64 evaluation: tests/torch_match_witness.py);
    each feature that changes shifts the match rounds' per-candidate
    draws, so the rounds pick other groups.  There n_matches is held
    within 2%, R within 1e-3, epi_avg within 0.02 px, and T within 2e-2:
    at 0.2 MP the quasi-planar scene leaves T's view-axis component weakly
    determined (tests/test_pipeline_e2e.py:112-119: ~1.6e-2 across
    estimator variants).  Both poses are printed against the truth."""
    sc = make_scene(seed=3, width=512, height=384, wave_amplitude=0.25)
    rig = sc.rig
    kw = dict(num_features=1500, iidyn_iters=8000, max_rounds=10, hessian_threshold=3e-5, feature_grid_cell=8)
    seen = []
    detect = j_pipeline.detect_features

    def record(*args, **kwargs):
        seen.append(detect(*args, **kwargs))
        return seen[-1]

    monkeypatch.setattr(j_pipeline, "detect_features", record)
    rj = j_match_frame(sc.img0, sc.img1, rig.K0, rig.K1, JMatchConfig(**kw))
    cfg = MatchConfig(**kw)
    if features == "jax":
        given = [FeatureSet(*(torch.from_numpy(np.array(a)) for a in f)) for f in seen]
        monkeypatch.setattr(t_pipeline, "detect_features", lambda *args, **kwargs: given.pop(0))
    k_match, k_ransac = jax.random.split(jax.random.PRNGKey(cfg.seed))
    C = 1500 * cfg.n_candidates_per_feature
    idx_h, idx_e = pose_draws(k_ransac, cfg.ransac_hypotheses, ransac_capacity(len(rj.uv0_all)))
    draws = MatchDraws(_t(round_uniforms(k_match, cfg.max_rounds, C)), idx_h, idx_e)
    rt = match_frame(sc.img0, sc.img1, rig.K0, rig.K1, cfg, device="cpu", draws=draws)
    Tg = rig.T / np.linalg.norm(rig.T)
    print(f"{features} features: matches jax {rj.n_matches} port {rt.n_matches}; epi {rj.epi_avg:.4f} "
          f"{rt.epi_avg:.4f}; |dR| to the truth {np.abs(rj.R - rig.R).max():.3g} {np.abs(rt.R - rig.R).max():.3g}, "
          f"|dT| {np.abs(rj.T.ravel() - Tg).max():.3g} {np.abs(rt.T.ravel() - Tg).max():.3g}")
    if features == "jax":
        for name in ("uv0_all", "uv0_epi", "uv0_pose"):
            assert len(getattr(rt, name)) == len(getattr(rj, name))
        np.testing.assert_array_equal(rt.uv0_all, rj.uv0_all)
        np.testing.assert_allclose(rt.R, rj.R, atol=1e-4)
        np.testing.assert_allclose(rt.T, rj.T, atol=1e-4)
        assert abs(rt.epi_avg - rj.epi_avg) <= 1e-3
    else:
        assert abs(rt.n_matches - rj.n_matches) <= 0.02 * rj.n_matches
        np.testing.assert_allclose(rt.R, rj.R, atol=1e-3)
        np.testing.assert_allclose(rt.T, rj.T, atol=2e-2)
        assert abs(rt.epi_avg - rj.epi_avg) <= 0.02
    assert rt.n_matches >= 60 and rt.epi_avg <= 0.6
    assert np.abs(rt.R - rig.R).max() < 2e-2
    assert np.abs(rt.T.ravel() - Tg).max() < 5e-2
