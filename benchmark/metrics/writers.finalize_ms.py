"""A writer's time a frame: the deferred c2f decision and any re-run, the
.xyzC fetch and write, the small files, the renders where they are on (the
mean of the "finalize wall time" lines of the window's
wass_stereo_log.txt files, written to the millisecond)."""


def read(ctx):
    s = [f["finalize_s"] for f in ctx.frames if f.get("finalize_s") is not None]
    return 1e3 * sum(s) / len(s) if s else None
