"""Input preparation helpers."""
