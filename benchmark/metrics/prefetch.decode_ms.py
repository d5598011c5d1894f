"""One PNG decode on the prefetch threads (the mean of
SequencePipeline.loop_stats["decode_s"], two images a frame)."""


def read(ctx):
    s = ctx.loop_stats.get("decode_s") or []
    return 1e3 * sum(s) / len(s) if s else None
