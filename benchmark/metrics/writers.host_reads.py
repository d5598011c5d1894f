"""Blocking device-to-host reads a writer makes for its frame: the reads
made through instrument.host_read outside the dispatching thread (the
mean of SequencePipeline.loop_stats["writer_host_reads"] over the
window's frames).  A program that keeps no such counter reads nothing."""


def read(ctx):
    s = ctx.loop_stats.get("writer_host_reads") or []
    return sum(s) / len(s) if s else None
