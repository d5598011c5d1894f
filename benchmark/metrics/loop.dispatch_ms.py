"""The dispatching thread's time a frame: upload, rectification and the
dense frame's launches, with the plane's host read (the mean of
SequencePipeline.loop_stats["dispatch_s"] over the window's frames)."""


def read(ctx):
    s = ctx.loop_stats.get("dispatch_s") or []
    return 1e3 * sum(s) / len(s) if s else None
