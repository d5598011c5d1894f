"""The dispatching thread held back by the writers: its wait for the
oldest frame's writer when dispatch_depth frames are in flight (the mean
of SequencePipeline.loop_stats["loop.writer_wait"] over the window's
frames; the wait for the last frames after the loop is loop.drain)."""


def read(ctx):
    s = ctx.loop_stats.get("loop.writer_wait") or []
    return 1e3 * sum(s) / len(s) if s else None
