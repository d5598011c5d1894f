"""The stereo settings of a configuration, in the reference's terms.

A configuration file names its stereo_config.txt keys (the reference's
names, wass_stereo.cpp); unnamed keys take the registry defaults below,
copied from wass_tpu_torch/cli/options.py.  stereo_config() maps them to
the frame's DenseStereoConfig as that module's stereo_config_from_registry
does, and stereo_config_text() writes them in the file format the
program's `load_pipeline` reads.
"""

from __future__ import annotations

from .frame import DenseStereoConfig

DEFAULTS = {
    "RANDOM_SEED": -1,
    "MIN_TRIANGULATED_POINTS": 100,
    "ZGAP_PERCENTILE": 99.0,
    "PLANE_RANSAC_ROUNDS": 400,
    "PLANE_RANSAC_THRESHOLD": 1.0,
    "PLANE_MAX_DISTANCE": 1.5,
    "MIN_DISPARITY": 1,
    "MAX_DISPARITY": 640,
    "DENSE_SCALE": 1.0,
    "DISP_DILATE_STEPS": 1,
    "DISP_EROSION_STEPS": 2,
    "MEDIAN_FILTER_WSIZE": 0,
    "DENSE_P1_MULT": 2,
    "DENSE_P2_MULT": 64,
    "DENSE_UNIQUENESS_RATIO": 1,
    "DENSE_DISP12MAXDIFF": -1,
    "DENSE_DISPARITY_BIGGEST_COMPONENT_THRESHOLD": 0,
    "TRIANG_MIN_ANGLE": 20.0,
    "DISCARD_BURNED_AREAS": True,
    "PLANE_WEIGHT_PROPORTIONAL_TO_DISTANCE": True,
    "PLANE_REFINEMENT_MAX_DISTANCE": 70.0,
    "DENSE_INPUT_SMOOTH_SIGMA": -1.0,
}


def settings(overrides: dict) -> dict:
    unknown = set(overrides) - set(DEFAULTS)
    if unknown:
        raise ValueError(f"stereo keys the reference does not map: {sorted(unknown)}")
    return {**DEFAULTS, **overrides}


def stereo_config(overrides: dict) -> DenseStereoConfig:
    g = settings(overrides)
    num_disp = max(g["MAX_DISPARITY"] - max(g["MIN_DISPARITY"], 0), 16)
    num_disp = -(-num_disp // 32) * 32  # a multiple of 32
    return DenseStereoConfig(
        num_disp=num_disp,
        min_disp=g["MIN_DISPARITY"],
        p1=4 * g["DENSE_P1_MULT"],
        p2=int(1.5 * g["DENSE_P2_MULT"]),
        uniqueness_ratio=g["DENSE_UNIQUENESS_RATIO"],
        lr_max_diff=g["DENSE_DISP12MAXDIFF"],
        dense_scale=g["DENSE_SCALE"],
        disp_dilate_steps=g["DISP_DILATE_STEPS"],
        disp_erosion_steps=g["DISP_EROSION_STEPS"],
        median_filter_wsize=g["MEDIAN_FILTER_WSIZE"],
        biggest_component_grad_threshold=float(g["DENSE_DISPARITY_BIGGEST_COMPONENT_THRESHOLD"]),
        min_angle_deg=g["TRIANG_MIN_ANGLE"],
        discard_burned=g["DISCARD_BURNED_AREAS"],
        zgap_percentile=g["ZGAP_PERCENTILE"],
        plane_ransac_rounds=g["PLANE_RANSAC_ROUNDS"],
        plane_ransac_threshold=g["PLANE_RANSAC_THRESHOLD"],
        plane_max_distance=g["PLANE_MAX_DISTANCE"],
        plane_refine_max_distance=g["PLANE_REFINEMENT_MAX_DISTANCE"],
        plane_weight_by_distance=g["PLANE_WEIGHT_PROPORTIONAL_TO_DISTANCE"],
        min_triangulated=g["MIN_TRIANGULATED_POINTS"],
        random_seed=max(g["RANDOM_SEED"], 0),
        input_smooth_sigma=g["DENSE_INPUT_SMOOTH_SIGMA"],
    )


def stereo_config_text(overrides: dict) -> str:
    """KEY=value lines of every mapped key (booleans as true / false)."""
    def fmt(v):
        return ("true" if v else "false") if isinstance(v, bool) else str(v)

    return "".join(f"{k}={fmt(v)}\n" for k, v in settings(overrides).items())


def check_fixed(cfg: DenseStereoConfig, fixed: dict) -> None:
    """Raise where a configuration names a setting that has no
    stereo_config.txt key at another value than the frame's default: the
    program could not be given it."""
    for k, v in fixed.items():
        if k == "note":
            continue
        have = getattr(cfg, k)
        if (tuple(have) if isinstance(have, tuple) else have) != (tuple(v) if isinstance(v, list) else v):
            raise ValueError(f"{k} = {v!r} cannot be set through stereo_config.txt (the frame's value: {have!r})")
