"""The share of the window's frames whose device work the dispatching
thread replayed from CUDA graphs: 100 x the mean of
SequencePipeline.loop_stats["dense_graph_replays"] (1 a replayed frame)
over the window's frames.  A program that keeps no such counter reads
nothing."""


def read(ctx):
    s = ctx.loop_stats.get("dense_graph_replays") or []
    return 100.0 * sum(s) / len(s) if s else None
