"""The dispatching thread's wait for a frame's decoded pair: Prefetcher.take
of its two images (the mean of SequencePipeline.loop_stats["loop.take"],
the span's seconds a frame, over the window's frames)."""


def read(ctx):
    s = ctx.loop_stats.get("loop.take") or []
    return 1e3 * sum(s) / len(s) if s else None
