"""The rig reads of a frame's dispatch: both intrinsics files, the
extrinsics and the cached frame geometry (the mean of
SequencePipeline.loop_stats["loop.rig"] over the window's frames)."""


def read(ctx):
    s = ctx.loop_stats.get("loop.rig") or []
    return 1e3 * sum(s) / len(s) if s else None
