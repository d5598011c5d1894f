"""A writer's wait for its frame's device work: the wait on its CUDA
stream and the first host read behind it (the c2f scalars, or the point
count without c2f), and the point count's read after a full-range re-run
(the mean of SequencePipeline.loop_stats["writer.device_wait"] over the
window's frames)."""


def read(ctx):
    s = ctx.loop_stats.get("writer.device_wait") or []
    return 1e3 * sum(s) / len(s) if s else None
