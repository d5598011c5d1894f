"""Port parity: the match stage's pieces (wass_tpu_torch/match: iidyn,
features, candidates, payoff and rounds, LK) against the JAX package, on
the same inputs and the same random draws (RANSAC, pose and the whole
frame stage: tests/test_torch_match_pose.py).

The JAX package draws inside its functions from jax.random keys; the port
takes its draws as tensors.  These tests build the JAX draws with the same
split / uniform / randint calls on the same keys and hand them to the
port, so both packages compute on the same samples."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wass_tpu.match import features as jfeat
from wass_tpu.match import matcher as jmatch
from wass_tpu.match.iidyn import iidyn as j_iidyn
from wass_tpu.match.iidyn import initial_population as j_init
from wass_tpu.match.refine import refine_matches_lk as j_refine
from wass_tpu.testing import make_scene
from wass_tpu_torch.match import features as tfeat
from wass_tpu_torch.match import iidyn as tiidyn
from wass_tpu_torch.match import matcher as tmatch
from wass_tpu_torch.match.refine import refine_matches_lk


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


# --- iidyn -------------------------------------------------------------------


def _test_match_matrix(rng, case):
    """The two matrices of tests/test_match.py:54-78: a dominant 12-clique,
    and a flat 8-clique with half of it masked out."""
    if case == "clique":
        n, g = 40, 12
        A = rng.random((n, n)) * 0.05
        A[:g, :g] = 0.95 + rng.random((g, g)) * 0.05
    else:
        n, g = 30, 8
        A = rng.random((n, n)) * 0.05
        A[:g, :g] = 0.9
    A = (A + A.T) / 2
    np.fill_diagonal(A, 0)
    mask = np.ones(n, bool)
    if case == "mask":
        mask[:4] = False
    return A.astype(np.float32), mask


def _payoff300(features):
    """A 300-candidate payoff (the first 100 features of each image x 3
    candidates) of a synthetic pair."""
    fa, fb = (jfeat.FeatureSet(*(a[:100] for a in f)) for f in features)
    cand = jmatch.generate_candidates(fa, fb)
    return np.asarray(jmatch.payoff_matrix(fa, fb, cand)), np.asarray(cand.valid)


@pytest.fixture(scope="module")
def jax_features():
    """The JAX package's FeatureSets of a 256x192 synthetic pair (300 each)."""
    sc = make_scene(seed=3, width=256, height=192, wave_amplitude=0.25)
    return [jfeat.detect_features(jfeat._gauss_blur(jnp.asarray(img, jnp.float32), 0.8), max_features=300,
                                  hessian_threshold=3e-5, grid_cell=8) for img in (sc.img0, sc.img1)]


@pytest.mark.parametrize("case", ["clique", "mask", "payoff300"])
def test_iidyn_plain_matches_jax(rng, jax_features, case):
    """Same support, x within 1e-5, and n_iters within 2% (at least 2) of
    the JAX loop's.

    The loop stops when the Nash error falls below toll^2 = 1e-12, and the
    error is a sum of (xAx - Ax_i)^2, a difference at float32 resolution:
    near the end it hovers at the threshold, and xAx summed in another
    order (XLA's CPU dot sums serially, the port in the CUDA kernel's
    order, so that the plain loop and the kernel agree bit for bit) moves
    the exit by a few iterations.  The test prints both counts."""
    if case == "payoff300":
        A, mask = _payoff300(jax_features)
        key = jax.random.PRNGKey(3)
    else:
        A, mask = _test_match_matrix(rng, case)
        key = jax.random.PRNGKey(0)
    x0 = np.asarray(j_init(key, len(A), jnp.asarray(mask)))
    xj, itj, ej = j_iidyn(jnp.asarray(A), jnp.asarray(x0), mask=jnp.asarray(mask), max_iters=5000)
    xt, itt, et = tiidyn.iidyn(_t(A), _t(x0), mask=_t(mask), max_iters=5000)
    xj = np.asarray(xj)
    print(f"{case}: n_iters jax {int(itj)} port {int(itt)}; nash error {float(ej):.3g} {float(et):.3g}")
    assert abs(int(itt) - int(itj)) <= max(2, 0.02 * int(itj))
    np.testing.assert_allclose(xt.numpy(), xj, atol=1e-5)
    np.testing.assert_array_equal(xt.numpy() > 1e-4, xj > 1e-4)
    if case == "mask":
        assert xt.numpy()[:4].sum() == 0
    if case == "clique":
        assert xt.numpy()[:12].sum() > 0.95


@pytest.mark.parametrize("max_iters", [0, 1, 7])
def test_iidyn_plain_short_runs_match_jax(rng, max_iters):
    """Capped runs stop at the cap with the same count and the same x."""
    A, _ = _test_match_matrix(rng, "clique")
    x0 = np.asarray(j_init(jax.random.PRNGKey(1), 40))
    xj, itj, ej = j_iidyn(jnp.asarray(A), jnp.asarray(x0), max_iters=max_iters)
    xt, itt, et = tiidyn.iidyn(_t(A), _t(x0), max_iters=max_iters)
    assert int(itt) == int(itj) == max_iters
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-6)
    np.testing.assert_allclose(float(et), float(ej), rtol=1e-4, atol=1e-9)


def _cluster_mask(rng, C, case):
    """The live sets of the order test: all live; 27% live; half live with
    a run of C / GROUPS columns that holds nothing live (one CTA's range,
    were the columns split evenly); one live."""
    if case == "all":
        return np.ones(C, bool)
    if case == "27%":
        return rng.random(C) < 0.27
    if case == "one":
        live = np.zeros(C, bool)
        live[rng.integers(C)] = True
        return live
    live = rng.random(C) < 0.5
    R = -(-C // tiidyn.GROUPS)
    live[R:2 * R] = False
    return live


@pytest.mark.parametrize("mask", ["all", "27%", "empty run", "one"])
@pytest.mark.parametrize("C", [5, 1024, 1500, 12000, 40000])
def test_block_sum_is_the_kernels_order(rng, C, mask):
    """_block_sum adds as csrc/iidyn.cu's cluster reduction does, modelled
    here one float32 add at a time: of the L live candidates in index
    order, CTA g holds those of rank [g L // GROUPS, (g + 1) L // GROUPS);
    thread t sums the CTA's elements t, t + THREADS, ... from 0; xor
    shuffles fold each warp's lanes, then the warp sums, then the CTA sums
    (the last two modelled as a 32-lane butterfly with 0 beyond them: the
    same bits as the kernel's narrower butterflies).  With one live
    candidate all CTAs but one hold nothing; C = 40000 gives a CTA more
    live candidates than its threads' chunks of loads (4 x THREADS), so the
    update pass loops."""
    G, T = tiidyn.GROUPS, tiidyn.THREADS
    v = rng.standard_normal((2, C)).astype(np.float32)
    live = _cluster_mask(rng, C, mask)
    cols = np.flatnonzero(live)
    L = len(cols)

    def butterfly(a):
        a = np.array(list(a) + [0.0] * (32 - len(a)), np.float32)
        for o in (16, 8, 4, 2, 1):
            a = np.array([np.float32(a[lane] + a[lane ^ o]) for lane in range(32)], np.float32)
        return a[0]

    ref = []
    for row in v:
        parts = []
        for g in range(G):
            lanes = np.zeros(T, np.float32)
            for j, c in enumerate(cols[g * L // G:(g + 1) * L // G]):
                lanes[j % T] = np.float32(lanes[j % T] + row[c])
            parts.append(butterfly([butterfly(w) for w in lanes.reshape(T // 32, 32)]))
        ref.append(butterfly(parts))
    got = tiidyn._block_sum(_t(v), tiidyn._layout(_t(live))).numpy()
    np.testing.assert_array_equal(got, np.array(ref, np.float32))


def test_initial_population_matches_jax(rng):
    mask = rng.random(50) < 0.7
    key = jax.random.PRNGKey(4)
    u = np.asarray(jax.random.uniform(key, (50,)))
    ref = np.asarray(j_init(key, 50, jnp.asarray(mask)))
    np.testing.assert_allclose(tiidyn.initial_population(_t(u), _t(mask)).numpy(), ref, rtol=1e-6)


def test_iidyn_cuda_tensor_never_falls_back(monkeypatch):
    """A tensor the wrapper takes for a CUDA one launches the kernel or
    raises: with no kernel library to build here, it raises."""
    from wass_tpu_torch import _build

    def no_library():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(tiidyn, "on_cuda", lambda *t: True)
    monkeypatch.setattr(_build, "load", no_library)
    A = torch.ones((4, 4)) - torch.eye(4)
    with pytest.raises(RuntimeError, match="nvcc"):
        tiidyn.iidyn(A, torch.ones(4))
    assert tiidyn.LAUNCHES["iidyn"] == 0


# --- features ----------------------------------------------------------------


def _texture(rng):
    img = (rng.random((192, 256)) * 255).astype(np.float32)
    return cv2.GaussianBlur(img, (0, 0), 2) * 4


def _compare_features(fj, ft, xy_tol, fine_tol):
    """Cells in common (by the integer pixel of the winner), then the common
    features' xy, angle and descriptors."""
    vj, vt = np.asarray(fj.valid), ft.valid.numpy()
    cells = lambda f, v: {tuple(np.floor(p).astype(int)): i for i, (p, ok) in enumerate(zip(np.asarray(f), v)) if ok}  # noqa: E731
    cj, ct = cells(fj.xy, vj), cells(ft.xy.numpy(), vt)
    common = sorted(set(cj) & set(ct))
    assert len(common) >= 0.98 * max(len(cj), len(ct)) and len(cj) > 50
    ij = np.array([cj[c] for c in common])
    it = np.array([ct[c] for c in common])
    np.testing.assert_allclose(ft.xy.numpy()[it], np.asarray(fj.xy)[ij], atol=xy_tol)
    if fine_tol is not None:
        da = np.abs(ft.angle.numpy()[it] - np.asarray(fj.angle)[ij])
        assert np.minimum(da, 2 * np.pi - da).max() <= fine_tol
        np.testing.assert_allclose(ft.desc.numpy()[it], np.asarray(fj.desc)[ij], atol=fine_tol)
        np.testing.assert_array_equal(ft.scale.numpy()[it], np.asarray(fj.scale)[ij])


def test_detect_features_with_the_reference_blur(rng, monkeypatch):
    """The detector after the blur, against the JAX function run op by op
    (XLA's jit contracts the Hessian determinant into FMAs), both on the
    JAX package's blurred planes: >= 98% of the selected cells in common,
    xy within 1e-3 px, angle and descriptors within 1e-4."""
    img = _texture(rng)
    monkeypatch.setattr(tfeat, "gauss_blur",
                        lambda x, s: _t(np.asarray(jfeat._gauss_blur(jnp.asarray(x.numpy()), s))))
    with jax.disable_jit():
        fj = jfeat.detect_features(jnp.asarray(img), max_features=256)
    ft = tfeat.detect_features(_t(img), max_features=256)
    _compare_features(fj, ft, 1e-3, 1e-4)


def test_detect_features_matches_jax(rng):
    """The whole detector, blur included: >= 98% of the selected cells in
    common.  The Hessian response is a difference of second differences,
    which turns the blurs' float32 rounding (their sums run in another
    order than XLA's convolution for the wider kernels) into ~2e-3 of the
    response; so xy is held to 5e-3 px here and tightly in the test above."""
    img = _texture(rng)
    fj = jfeat.detect_features(jnp.asarray(img), max_features=256)
    ft = tfeat.detect_features(_t(img), max_features=256)
    _compare_features(fj, ft, 5e-3, None)
    d = ft.desc.numpy()[ft.valid.numpy()]
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-4)


@pytest.mark.parametrize("sigma", [0.8, 1.6, 21.57])
def test_blur_matches_jax(rng, sigma):
    """Bit-equal for the 5-tap sigma 0.8 kernel, float32 rounding above."""
    img = (rng.random((40, 90)) * 255).astype(np.float32)
    ref = np.asarray(jfeat._gauss_blur(jnp.asarray(img), sigma))
    out = tfeat.gauss_blur(_t(img), sigma).numpy()
    if sigma == 0.8:
        np.testing.assert_array_equal(out, ref)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


# --- candidates, payoff, rounds -----------------------------------------------


def _to_port(f):
    return tfeat.FeatureSet(*(torch.from_numpy(np.array(a)) for a in f))


def test_candidates_payoff_and_rounds_match_jax(jax_features):
    """Fed the JAX package's FeatureSets: identical candidates, payoff
    within 1e-6, the same winners and rounds."""
    fa, fb = jax_features
    ta, tb = _to_port(fa), _to_port(fb)
    cj = jmatch.generate_candidates(fa, fb)
    ct = tmatch.generate_candidates(ta, tb)
    valid = np.asarray(cj.valid)
    np.testing.assert_array_equal(ct.valid.numpy(), valid)
    np.testing.assert_array_equal(ct.src.numpy(), np.asarray(cj.src))
    np.testing.assert_array_equal(ct.dst.numpy()[valid], np.asarray(cj.dst)[valid])
    np.testing.assert_array_equal(ct.nndr_best.numpy(), np.asarray(cj.nndr_best))

    pj = np.asarray(jmatch.payoff_matrix(fa, fb, cj))
    pt = tmatch.payoff_matrix(ta, tb, ct)
    np.testing.assert_allclose(pt.numpy(), pj, rtol=0, atol=1e-6)

    key = jax.random.PRNGKey(9)
    rounds, iters = 6, 3000
    rj = jmatch.gt_match(fa, fb, cj, jnp.asarray(pj), key, max_rounds=rounds, iidyn_iters=iters)
    rt = tmatch.gt_match(ta, tb, ct, pt, _t(round_uniforms(key, rounds, len(valid))), max_rounds=rounds,
                         iidyn_iters=iters)
    print(f"rounds {int(rj.n_rounds)} {rt.n_rounds}; winners {int(rj.valid.sum())} {int(rt.valid.sum())}")
    assert rt.n_rounds == int(rj.n_rounds)
    np.testing.assert_array_equal(rt.valid.numpy(), np.asarray(rj.valid))
    near = tmatch.nearest_match(ct)
    np.testing.assert_array_equal(near.valid.numpy(), np.asarray(jmatch.nearest_match(cj).valid))


def test_refine_matches_lk_matches_jax(rng):
    big = cv2.GaussianBlur((rng.random((160, 200)) * 255).astype(np.float32), (0, 0), 1.5) * 4
    img0, img1 = big[:128, :160], big[3:131, 5:165]
    uv0 = rng.uniform(20, 120, (60, 2)).astype(np.float32)
    uv1 = (uv0 - [5, 3] + rng.normal(0, 0.7, uv0.shape)).astype(np.float32)
    ref = np.asarray(j_refine(jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(uv0), jnp.asarray(uv1), win=7))
    out = refine_matches_lk(_t(img0), _t(img1), _t(uv0), _t(uv1), win=7).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-3)
    assert np.median(np.abs(out - (uv0 - [5, 3]))) < 0.05
