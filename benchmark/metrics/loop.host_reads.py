"""Blocking device-to-host reads on the dispatching thread a frame: the
reads made through instrument.host_read (the mean of
SequencePipeline.loop_stats["host_reads"] over the window's frames)."""


def read(ctx):
    s = ctx.loop_stats.get("host_reads") or []
    return sum(s) / len(s) if s else None
