"""Command-line entry point and the sequence stereo loop."""
