"""Dense stereo: census, cost volume, SGM, plane fit, the frame pipeline."""
