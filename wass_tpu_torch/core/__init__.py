"""Host geometry (float64 numpy) and batched tensor geometry."""
