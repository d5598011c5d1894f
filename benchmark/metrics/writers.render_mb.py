"""The uint8 bytes of a frame's debug renders fetched to the host, in MB
(the mean of the counter SequencePipeline.loop_stats["render_bytes"] over
the window's frames, / 1e6); nothing where renders are off."""


def read(ctx):
    s = ctx.loop_stats.get("render_bytes") or []
    return 1e-6 * sum(s) / len(s) if s else None
