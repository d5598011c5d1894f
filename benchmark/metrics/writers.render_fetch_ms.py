"""The copies of a frame's six uint8 render images to the host on its
writer, each waiting for the device work that builds its image (the mean of
SequencePipeline.loop_stats["writer.render.fetch"] over the window's
frames); nothing where renders are off."""


def read(ctx):
    s = ctx.loop_stats.get("writer.render.fetch") or []
    return 1e3 * sum(s) / len(s) if s else None
