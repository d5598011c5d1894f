"""A writer's fetch of its frame: the plane's read, the .xyzC export on
the card and the device-to-host reads of its payload, mins and scales
(the mean of SequencePipeline.loop_stats["writer.fetch"] over the
window's frames)."""


def read(ctx):
    s = ctx.loop_stats.get("writer.fetch") or []
    return 1e3 * sum(s) / len(s) if s else None
