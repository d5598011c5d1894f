"""Reference-compatible prepare, matcher and stereo options and their
mapping to the configs.

Copied from the prepare, matcher and stereo blocks of
wass_tpu/cli/options.py (register_all and the *_config_from_registry
functions, flow_config_from_registry included), whose package imports jax, onto the port's own registries
(wass_tpu_torch/config.py): the reference's prepare_config.txt,
matcher_config.txt and stereo_config.txt names and defaults
(wass_prepare.cpp:36-39; wass_match.cpp:39-45, FeatureSet.cpp:42-47,
GTMatcher.cpp:33; wass_stereo.cpp:52-84, 742-761, 1030-1037,
PovMesh.cpp:577-579).
"""

from __future__ import annotations

from wass_tpu_torch.config import matcher_cfg, prepare_cfg, stereo_cfg


def register_all() -> None:
    # ---- prepare (wass_prepare.cpp:36-39) --------------------------------
    prepare_cfg.register(float, "CAM0_CLAHE_CLIPLIMIT", 2.0, "CAM0 CLAHE cliplimit parameter")
    prepare_cfg.register(int, "CAM0_CLAHE_TILEGRIDSIZE", 0, "CAM0 CLAHE tile grid size (set to 0 to disable CLAHE). 150 is a good value to start")
    prepare_cfg.register(float, "CAM1_CLAHE_CLIPLIMIT", 2.0, "CAM1 CLAHE cliplimit parameter")
    prepare_cfg.register(int, "CAM1_CLAHE_TILEGRIDSIZE", 0, "CAM1 CLAHE tile grid size (set to 0 to disable CLAHE). 150 is a good value to start")

    # ---- matcher ---------------------------------------------------------
    m = matcher_cfg
    m.register(int, "NUM_FEATURES_PER_IMAGE", 0, "Maxmum number of image features to extract (0 = auto: 2000 below 1.5 MP, 4000 above)")
    m.register(float, "MATCHER_LAMBDA", 1e-5, "Matcher payoff lambda")
    m.register(float, "MATCHER_POPULATION_THRESHOLD", 0.7, "Matcher population threshold")
    m.register(int, "MATCHER_MIN_GROUP_SIZE", 5, "Matcher minimum required group size")
    m.register(int, "MATCHER_MAX_ROUNDS", 20, "Matcher maximum number of rounds to perform")
    m.register(float, "MATCHER_MAX_EPI_DISTANCE", 0.5, "Max matches epipolar distance")
    m.register(bool, "MATCHER_SKIP_GT", False, "Skip game-theoretic matcher and use the nearest match only.")
    m.register(float, "FEATURE_MIN_DISTANCE", 0.0, "Minimum distance allowed between two features (in px; 0 = auto: 12 below 1.5 MP, 8 above)")
    m.register(float, "FEATURE_HESSIAN_THRESHOLD", 0.0001, "Detector determinant-of-Hessian threshold")
    m.register(int, "FEATURE_N_OCTAVES", 4, "Scale-space octaves")
    m.register(int, "FEATURE_N_LAYERS", 4, "Scale-space layers per octave")
    m.register(int, "FEATURE_INIT_SAMPLES", 1, "Compatibility option (OpenSURF init samples)")
    m.register(int, "AREA_SUBDIVISION", 5, "Number of image subdivisons to improve feature distribution")
    m.register(float, "NNDR", 0.25, "Nearest neighbour distance ratio used to select best matches. Note: ignored if MATCHER_SKIP_GT=false")
    # Framework extensions (not in the reference's INCFG set):
    m.register(float, "MATCHER_INPUT_SMOOTH_SIGMA", -1.0, "Gaussian pre-smoothing of the 8-bit inputs before detection/LK (negative = AUTO from the estimated input degradation; 0 disables)")
    m.register(int, "MATCHER_LK_WIN", 0, "LK refinement half-window (0 = auto: scales with image width)")

    # ---- stereo ----------------------------------------------------------
    s = stereo_cfg
    s.register(int, "RANDOM_SEED", -1, "Random seed for ransac. -1 to use system timer")
    s.register(int, "MIN_TRIANGULATED_POINTS", 100, "Minimum number of triangulated point to proceed with plane estimation")
    s.register(float, "SAVE_INPUT_SCALE", 0.3, "Save a scaled version of input images (Set 1 to skip or a value <1 to specify scale ratio)")
    s.register(float, "ZGAP_PERCENTILE", 99.0, "Z-gap percentile for outlier filtering")
    s.register(bool, "DISABLE_AUTO_LEFT_RIGHT", False, "Disable automatic left-right detection")
    s.register(bool, "SWAP_LEFT_RIGHT", False, "Swaps left-right images (only valid if DISABLE_AUTO_LEFT_RIGHT is set)")
    s.register(bool, "SAVE_FULL_MESH", False, "Save 3D point cloud before plane outlier removal")
    s.register(int, "PLANE_RANSAC_ROUNDS", 400, "number of RANSAC rounds for plane estimation")
    s.register(float, "PLANE_RANSAC_THRESHOLD", 1.0, "RANSAC inlier threshold")
    s.register(float, "PLANE_REFINE_XMIN", -9999, "Minimum point x-coordinate for plane refinement")
    s.register(float, "PLANE_REFINE_XMAX", 9999, "Maximum point x-coordinate for plane refinement")
    s.register(float, "PLANE_REFINE_YMIN", -9999, "Minimum point y-coordinate for plane refinement")
    s.register(float, "PLANE_REFINE_YMAX", 9999, "Maximum point y-coordinate for plane refinement")
    s.register(float, "PLANE_MAX_DISTANCE", 1.5, "Maximum point-plane distance allowed for the reconstructed point-cloud")
    s.register(bool, "SAVE_AS_PLY", False, "Save final reconstructed point cloud also in PLY format")
    s.register(bool, "SAVE_COMPRESSED", True, "Save in 16-bit compressed format")
    s.register(bool, "USE_CUSTOM_STEREORECTIFY", False, "Use built-in stereorectify algorithm instead of the one provided by OpenCV")
    s.register(bool, "DISABLE_RECTIFY_ROI", False, "Disable automatic ROI computation during stereo rectification")
    s.register(float, "RECTIFY_ANGLE", 0.0, "Additional rotation to apply around the baseline")
    s.register(int, "MIN_DISPARITY", 1, "Minimum disparity allowed (in px)")
    s.register(int, "MAX_DISPARITY", 640, "Maximum disparity allowed")
    s.register(int, "WINSIZE", 13, "Stereo match window size (census window is derived)")
    s.register(float, "DENSE_SCALE", 1.0, "Image resize along epipolar lines before dense stereo")
    s.register(int, "DISPARITY_OFFSET", 0, "Offset in pixel to be applied")
    s.register(int, "DISP_DILATE_STEPS", 1, "Number of dilate steps to be applied to the disparity map")
    s.register(int, "DISP_EROSION_STEPS", 2, "Number of erosion steps to be applied to the disparity map")
    s.register(int, "MEDIAN_FILTER_WSIZE", 0, "Disparity median filter window size (0 to disable)")
    s.register(int, "DENSE_P1_MULT", 2, "SGM P1 smoothness penalty multiplier")
    s.register(int, "DENSE_P2_MULT", 64, "SGM P2 smoothness penalty multiplier")
    s.register(int, "DENSE_UNIQUENESS_RATIO", 1, "SGM Uniqueness ratio")
    s.register(int, "DENSE_DISP12MAXDIFF", -1, "SGM left-right max difference (-1 disables)")
    s.register(int, "DENSE_PREFILTER_CAP", 60, "Compatibility option (SGBM PreFilterCap)")
    s.register(int, "DENSE_SPECKLE_RANGE", 16, "Compatibility option (SGBM SpeckleRange)")
    s.register(int, "DENSE_SPECKLE_WINDOW_SIZE", -70, "Compatibility option (SGBM SpeckleWindowSize)")
    s.register(int, "DENSE_DISPARITY_BIGGEST_COMPONENT_THRESHOLD", 0, "Maximum squared gradient magnitude threshold for biggest connected component extraction (0 to disable)")
    s.register(float, "TRIANG_MIN_ANGLE", 20.0, "Minimum ray angle for triangulation (in degrees)")
    s.register(float, "TRIANG_BBOX_TOP", -1.0, "Triangulation bounding box top coordinate")
    s.register(float, "TRIANG_BBOX_LEFT", -1.0, "Triangulation bounding box left coordinate")
    s.register(float, "TRIANG_BBOX_RIGHT", -1.0, "Triangulation bounding box right coordinate")
    s.register(float, "TRIANG_BBOX_BOTTOM", -1.0, "Triangulation bounding box bottom coordinate")
    s.register(str, "LEFT_MASK_IMAGE", "none", "Filename of a (BW) left camera mask image")
    s.register(str, "RIGHT_MASK_IMAGE", "none", "Filename of a (BW) right camera mask image")
    s.register(bool, "DISCARD_BURNED_AREAS", True, "Discard white pixels (value>254)")
    s.register(bool, "PLANE_WEIGHT_PROPORTIONAL_TO_DISTANCE", True, "use point to camera distance as weight during LLS plane fitting")
    s.register(bool, "PLANE_USE_CENTRAL_THIRD_ONLY", False, "use only the central third of the image to estimate the mean sea plane")
    s.register(float, "PLANE_REFINEMENT_MAX_DISTANCE", 70.0, "max point distance for plane refinement")
    s.register(float, "DENSE_INPUT_SMOOTH_SIGMA", -1.0, "Gaussian pre-smoothing of the rectified images before the census transform (negative = AUTO from the estimated input degradation; 0 disables)")
    s.register(bool, "ENABLE_OPTICAL_FLOW", False, "Enable the optical-flow reconstruction path (mesh_full_flow.ply)")
    s.register(int, "FLOW_REFINEMENT_FULLRES_ITERATIONS", 200, "Number of iterations for flow refinement")
    s.register(float, "FLOW_REFINEMENT_COLOR_CONSISTENCY_FACTOR", 100, "Color consistency factor for both the low-res and high-res flow refinement")
    s.register(float, "FLOW_REFINEMENT_LOWRES_SMOOTHNESS_FACTOR", 90, "Smoothness factor for the low-res flow refinement")
    s.register(float, "FLOW_REFINEMENT_FULLRES_SMOOTHNESS_FACTOR", 300, "Smoothness factor for the full-res flow refinement")
    s.register(int, "FLOW_OPENING_DILATE", 1, "Dilate steps in flow mask")
    s.register(int, "FLOW_OPENING_ERODE", 1, "Erode steps in flow mask")


def stereo_config_from_registry():
    """Build the port's DenseStereoConfig from the registry's values."""
    from wass_tpu_torch.stereo.dense import DenseStereoConfig

    register_all()
    g = stereo_cfg.get
    num_disp = max(g("MAX_DISPARITY") - max(g("MIN_DISPARITY"), 0), 16)
    num_disp = -(-num_disp // 32) * 32  # round up to a multiple of 32
    return DenseStereoConfig(
        num_disp=num_disp,
        min_disp=g("MIN_DISPARITY"),
        p1=4 * g("DENSE_P1_MULT"),
        p2=int(1.5 * g("DENSE_P2_MULT")),
        uniqueness_ratio=g("DENSE_UNIQUENESS_RATIO"),
        lr_max_diff=g("DENSE_DISP12MAXDIFF"),
        dense_scale=g("DENSE_SCALE"),
        disp_dilate_steps=g("DISP_DILATE_STEPS"),
        disp_erosion_steps=g("DISP_EROSION_STEPS"),
        median_filter_wsize=g("MEDIAN_FILTER_WSIZE"),
        biggest_component_grad_threshold=float(g("DENSE_DISPARITY_BIGGEST_COMPONENT_THRESHOLD")),
        min_angle_deg=g("TRIANG_MIN_ANGLE"),
        discard_burned=g("DISCARD_BURNED_AREAS"),
        zgap_percentile=g("ZGAP_PERCENTILE"),
        plane_ransac_rounds=g("PLANE_RANSAC_ROUNDS"),
        plane_ransac_threshold=g("PLANE_RANSAC_THRESHOLD"),
        plane_max_distance=g("PLANE_MAX_DISTANCE"),
        plane_refine_max_distance=g("PLANE_REFINEMENT_MAX_DISTANCE"),
        plane_weight_by_distance=g("PLANE_WEIGHT_PROPORTIONAL_TO_DISTANCE"),
        min_triangulated=g("MIN_TRIANGULATED_POINTS"),
        random_seed=max(g("RANDOM_SEED"), 0),
        input_smooth_sigma=g("DENSE_INPUT_SMOOTH_SIGMA"),
    )


def flow_config_from_registry():
    """The port's FlowConfig from the registry's values; None unless
    ENABLE_OPTICAL_FLOW is set."""
    from wass_tpu_torch.stereo.flow import FlowConfig

    register_all()
    g = stereo_cfg.get
    if not g("ENABLE_OPTICAL_FLOW"):
        return None
    return FlowConfig(
        fullres_iterations=g("FLOW_REFINEMENT_FULLRES_ITERATIONS"),
        color_consistency=g("FLOW_REFINEMENT_COLOR_CONSISTENCY_FACTOR"),
        lowres_smoothness=g("FLOW_REFINEMENT_LOWRES_SMOOTHNESS_FACTOR"),
        fullres_smoothness=g("FLOW_REFINEMENT_FULLRES_SMOOTHNESS_FACTOR"),
        opening_dilate=g("FLOW_OPENING_DILATE"),
        opening_erode=g("FLOW_OPENING_ERODE"),
    )


def match_config_from_registry():
    """Build the port's MatchConfig from the registry's values."""
    from wass_tpu_torch.match.pipeline import MatchConfig

    register_all()
    g = matcher_cfg.get
    return MatchConfig(
        num_features=g("NUM_FEATURES_PER_IMAGE"),
        nndr=g("NNDR"),
        matcher_lambda=g("MATCHER_LAMBDA"),
        population_threshold=g("MATCHER_POPULATION_THRESHOLD"),
        min_group_size=g("MATCHER_MIN_GROUP_SIZE"),
        max_rounds=g("MATCHER_MAX_ROUNDS"),
        max_epi_distance=g("MATCHER_MAX_EPI_DISTANCE"),
        skip_gt=g("MATCHER_SKIP_GT"),
        hessian_threshold=g("FEATURE_HESSIAN_THRESHOLD"),
        feature_grid_cell=0 if g("FEATURE_MIN_DISTANCE") <= 0 else max(int(g("FEATURE_MIN_DISTANCE")), 2),
        area_subdivision=g("AREA_SUBDIVISION"),
        input_smooth_sigma=g("MATCHER_INPUT_SMOOTH_SIGMA"),
        lk_win=g("MATCHER_LK_WIN"),
    )


def prepare_config_from_registry():
    """Build the port's PrepareConfig from the registry's values."""
    from wass_tpu_torch.prepare.prepare import PrepareConfig

    register_all()
    g = prepare_cfg.get
    return PrepareConfig(
        clahe_clip_limit_cam0=g("CAM0_CLAHE_CLIPLIMIT"),
        clahe_tile_px_cam0=g("CAM0_CLAHE_TILEGRIDSIZE"),
        clahe_clip_limit_cam1=g("CAM1_CLAHE_CLIPLIMIT"),
        clahe_tile_px_cam1=g("CAM1_CLAHE_TILEGRIDSIZE"),
    )
