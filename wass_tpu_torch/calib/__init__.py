"""Calibration: two-view bundle adjustment, the Sampson pose polish and the
sequence-wide autocalibration."""
