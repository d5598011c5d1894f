"""The dispatching thread's CPU time over a frame's dispatch
(time.thread_time_ns over the loop.dispatch span: the mean of
SequencePipeline.loop_stats["loop.dispatch.cpu"] over the window's
frames); against loop.dispatch_ms it tells the thread's own work from
its waits for the card, the interpreter lock and the scheduler."""


def read(ctx):
    s = ctx.loop_stats.get("loop.dispatch.cpu") or []
    return 1e3 * sum(s) / len(s) if s else None
