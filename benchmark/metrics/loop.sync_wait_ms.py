"""The dispatching thread waiting on the card: the plane refinement's
read of its 3x3 matrix before the host eigh, the frame's one counted host
read (the mean of SequencePipeline.loop_stats["plane.read"] over the
window's frames)."""


def read(ctx):
    s = ctx.loop_stats.get("plane.read") or []
    return 1e3 * sum(s) / len(s) if s else None
