"""The host JPEG encodes of a frame's six debug renders on its writer, the
clip, cast and BGR copy included (the mean of
SequencePipeline.loop_stats["writer.render.encode"] over the window's
frames); nothing where renders are off."""


def read(ctx):
    s = ctx.loop_stats.get("writer.render.encode") or []
    return 1e3 * sum(s) / len(s) if s else None
