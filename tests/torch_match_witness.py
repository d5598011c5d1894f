"""Same-input witness of the match and autocalibrate stages at 2048x1536.

Runs the JAX package's match_frame and autocalibrate_pooled, and the port's
counterparts on the CPU with the JAX package's random draws, on the
synthetic pair that chip_smoke.py's phase M matches (make_scene seed 7,
wave amplitude 0.25), at the matcher defaults and the Hessian thresholds
given.  Like phase M, autocalibrate pools three copies of the frame's
epipolar inliers.  Prints, for each threshold and package, the valid
features of each image, the matches, the epipolar error, the pose against
the rig, and the port's pose against the JAX package's, for the port with
its own features and on the JAX package's features; the last line is one
JSON object with the same numbers.

    JAX_PLATFORMS=cpu python tests/torch_match_witness.py --cache DIR [--thresholds 3e-5 1e-4] [--seeds 0 1 2]
        [--jitter 0.01 [--poses-out FILE]]

With --jitter S, the JAX package's stage alone runs on the pair plus
N(0, S) grey levels, one draw for each seed: the spread of its pose under
input changes far below the 8-bit step (S = 0: the pair itself, the
draws of seed 0); --poses-out writes those poses for
`python -m wass_tpu_torch.testing.extrinsics_mesh`, which makes the mesh
of each on the card.

DIR holds the rendered scene (scene_2048x1536_7.npz, rendered there when
missing).  Not collected by pytest: a 3 MP pair takes minutes on the CPU.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

TESTS = Path(__file__).resolve().parent
sys.path[:0] = [str(TESTS), str(TESTS.parent)]

import jax  # noqa: E402
import torch  # noqa: E402

import wass_tpu.match.pipeline as jmp  # noqa: E402
import wass_tpu_torch.match.pipeline as tmp  # noqa: E402
from test_torch_calib import autocal_draws  # noqa: E402
from test_torch_match_pose import pose_draws, round_uniforms  # noqa: E402
from wass_tpu.calib.autocalibrate import AutocalConfig as JAutocalConfig  # noqa: E402
from wass_tpu.calib.autocalibrate import autocalibrate_pooled as j_autocal  # noqa: E402
from wass_tpu_torch.calib.autocalibrate import AutocalConfig, autocalibrate_pooled  # noqa: E402
from wass_tpu_torch.match.features import FeatureSet  # noqa: E402
from wass_tpu_torch.testing import load_or_make_scene  # noqa: E402

POOL_COPIES = 3  # phase M's frames, all the same pair


def pose_error(R, T, rig) -> dict:
    """max |dR| and max |dT| (T normalized) against the rig."""
    T = np.asarray(T, np.float64).ravel()
    Tg = rig.T / np.linalg.norm(rig.T)
    return {"dR": float(np.abs(np.asarray(R) - rig.R).max()), "dT": float(np.abs(T / np.linalg.norm(T) - Tg).max())}


def recording_features(mod, out: list):
    """Wrap mod.detect_features so each call appends its FeatureSet."""
    fn = mod.detect_features

    def wrapped(*args, **kwargs):
        fs = fn(*args, **kwargs)
        out.append(fs)
        return fs

    mod.detect_features = wrapped
    return fn


def as_port_features(fs) -> FeatureSet:
    return FeatureSet(*(torch.from_numpy(np.array(a)) for a in fs))


def summary(r, features: list, secs: float, rig) -> dict:
    row = {"features": [int(np.asarray(f.valid).sum()) for f in features], "seconds": round(secs, 1)}
    if r is not None:
        row.update(matches_all=len(r.uv0_all), matches_epi=len(r.uv0_epi), matches=r.n_matches,
                   epi_avg=r.epi_avg, **pose_error(r.R, r.T, rig))
    return row


def difference(a, b) -> dict:
    return {"dR": float(np.abs(a.R - b.R).max()), "dT": float(np.abs(a.T.ravel() - b.T.ravel()).max())}


def run(img0, img1, rig, threshold: float, seed: int) -> dict:
    """One threshold: the JAX package's stage, the port's with its own
    features, and the port's on the JAX package's features (which isolates
    the rounds, LK and pose from the scale-space blur's rounding); each
    with the same draws (those of `seed`), then autocalibrate on each one's
    pool."""
    out = {"threshold": threshold, "seed": seed}
    cfg = tmp.MatchConfig(hessian_threshold=threshold, seed=seed)
    feats_j, feats_t = [], []
    fj, ft = recording_features(jmp, feats_j), recording_features(tmp, feats_t)
    try:
        t0 = time.time()
        rj = jmp.match_frame(img0, img1, rig.K0, rig.K1, jmp.MatchConfig(hessian_threshold=threshold, seed=seed))
        t_j = time.time() - t0
        k_match, k_ransac = jax.random.split(jax.random.PRNGKey(cfg.seed))
        # The AUTO budget and NMS cell; a feature set holds at most one feature a cell.
        n_feat, cell = (2000, 12) if img0.size <= 1.5e6 else (4000, 8)
        cells = -(-img0.shape[0] // cell) * -(-img0.shape[1] // cell)
        C = min(n_feat, cells) * cfg.n_candidates_per_feature
        n_all = len(rj.uv0_all) if rj is not None else 64
        idx_h, idx_e = pose_draws(k_ransac, cfg.ransac_hypotheses, tmp.ransac_capacity(n_all))
        draws = tmp.MatchDraws(torch.from_numpy(round_uniforms(k_match, cfg.max_rounds, C)), idx_h, idx_e)
        t0 = time.time()
        rt = tmp.match_frame(img0, img1, rig.K0, rig.K1, cfg, device="cpu", draws=draws)
        t_t = time.time() - t0
        queue = [as_port_features(f) for f in feats_j]
        tmp.detect_features = lambda *args, **kwargs: queue.pop(0)
        t0 = time.time()
        rtj = tmp.match_frame(img0, img1, rig.K0, rig.K1, cfg, device="cpu", draws=draws)
        t_tj = time.time() - t0
    finally:
        jmp.detect_features, tmp.detect_features = fj, ft

    out["jax"] = summary(rj, feats_j, t_j, rig)
    out["port"] = summary(rt, feats_t, t_t, rig)
    out["port_on_jax_features"] = summary(rtj, feats_j, t_tj, rig)
    if rj is None:
        return out
    for name, r in (("port", rt), ("port_on_jax_features", rtj)):
        if r is not None:
            out[name]["vs_jax"] = difference(r, rj)

    # autocalibrate over phase M's pool: the epipolar inliers of three copies.
    acfg = AutocalConfig(seed=seed)
    pooled = {}
    for name, r in (("jax", rj), ("port", rt), ("port_on_jax_features", rtj)):
        if r is None:
            continue
        pool = [np.concatenate([a] * POOL_COPIES) for a in (r.uv0_epi, r.uv1_epi)]
        if name == "jax":
            a = j_autocal(*pool, rig.K0, rig.K1, JAutocalConfig(seed=seed))
        else:
            a = autocalibrate_pooled(*pool, rig.K0, rig.K1, acfg, device="cpu",
                                     draws=autocal_draws(acfg.seed, acfg.ransac_hypotheses, len(pool[0])))
        pooled[name] = a
        out[name]["pooled"] = None if a is None else {"inliers": a.n_inliers, "epi_med_after": a.epi_med_after,
                                                      **pose_error(a.R, a.T, rig)}
    for name in ("port", "port_on_jax_features"):
        if pooled.get(name) is not None and pooled.get("jax") is not None:
            out[name]["pooled"]["vs_jax"] = difference(pooled[name], pooled["jax"])
    return out


def jax_under_jitter(img0, img1, rig, threshold: float, jitter: float, seed: int) -> dict:
    """The JAX package's stage alone (draws of seed 0) on the pair plus
    N(0, jitter) grey levels drawn with `seed`: how far its pose moves
    under a change of the input far below the 8-bit step, as the float32
    rounding of the two packages' scale spaces changes it."""
    rng = np.random.default_rng(seed)
    j0, j1 = (np.asarray(a, np.float64) + rng.normal(0.0, jitter, a.shape) for a in (img0, img1))
    r = jmp.match_frame(j0, j1, rig.K0, rig.K1, jmp.MatchConfig(hessian_threshold=threshold))
    out = {"threshold": threshold, "jitter": jitter, "jitter_seed": seed}
    if r is None:
        return out
    out["jax"] = summary(r, [], 0.0, rig)
    out["poses"] = {"match": pose(r)}
    pool = [np.concatenate([a] * POOL_COPIES) for a in (r.uv0_epi, r.uv1_epi)]
    a = j_autocal(*pool, rig.K0, rig.K1, JAutocalConfig())
    out["jax"]["pooled"] = None if a is None else {"inliers": a.n_inliers, **pose_error(a.R, a.T, rig)}
    if a is not None:
        out["poses"]["pooled"] = pose(a)
    return out


def pose(r) -> dict:
    return {"R": np.asarray(r.R, np.float64).tolist(), "T": np.asarray(r.T, np.float64).ravel().tolist()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cache", required=True, help="directory of the rendered scene")
    ap.add_argument("--thresholds", type=float, nargs="+", default=[3e-5, 1e-4])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0], help="MatchConfig/AutocalConfig seeds (the draws)")
    ap.add_argument("--jitter", type=float, default=None,
                    help="grey levels of N(0, jitter) added to the pair, one draw a seed: the JAX package alone")
    ap.add_argument("--poses-out", default=None,
                    help="with --jitter: write the JAX package's poses as JSON for wass_tpu_torch.testing.extrinsics_mesh")
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    scene = load_or_make_scene(2048, 1536, 7, args.cache)
    rows, poses = [], {}
    for thr in args.thresholds:
        for seed in args.seeds:
            if args.jitter is not None:
                row = jax_under_jitter(scene.img0, scene.img1, scene.rig, thr, args.jitter, seed)
                for kind, p in row.pop("poses", {}).items():
                    poses[f"jax_t{thr:g}_jitter{args.jitter:g}_seed{seed}_{kind}"] = p
            else:
                row = run(scene.img0, scene.img1, scene.rig, thr, seed)
            print(json.dumps(row), flush=True)
            rows.append(row)
    if args.poses_out:
        Path(args.poses_out).write_text(json.dumps(poses))
    print(json.dumps({"size": [2048, 1536], "scene_seed": 7, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
