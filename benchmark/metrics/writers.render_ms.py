"""The six debug renders of a frame on its writer: built on the card,
fetched, JPEG-encoded and written (the mean of
SequencePipeline.loop_stats["render_s"]); nothing where renders are off."""


def read(ctx):
    s = ctx.loop_stats.get("render_s") or []
    return 1e3 * sum(s) / len(s) if s else None
