"""Reference-compatible stereo options and their mapping to the config.

Copied from the stereo block of wass_tpu/cli/options.py (register_all and
stereo_config_from_registry), whose package imports jax, onto the jax-free
wass_tpu.config stereo registry: the reference's stereo_config.txt names
and defaults (wass_stereo.cpp:52-84, 742-761, 1030-1037, PovMesh.cpp:577-579).
"""

from __future__ import annotations

from wass_tpu.config import stereo_cfg


def register_all() -> None:
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
    # The optical-flow options are registered so that stereo_config.txt
    # files load unchanged; the port has no flow path yet.
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
