"""Image ops: sampling, morphology, connected components."""
