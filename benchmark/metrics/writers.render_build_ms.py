"""The device build of a frame's six debug renders on its writer, as
enqueued: render.stereo_renders' float64 torch calls on the writer's CUDA
stream (the mean of SequencePipeline.loop_stats["writer.render.build"]
over the window's frames); nothing where renders are off."""


def read(ctx):
    s = ctx.loop_stats.get("writer.render.build") or []
    return 1e3 * sum(s) / len(s) if s else None
