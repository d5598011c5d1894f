"""Sparse matching: features, the game-theoretic matcher (the iidyn kernel), LK
refinement, relative-pose RANSAC and the per-frame match stage."""
