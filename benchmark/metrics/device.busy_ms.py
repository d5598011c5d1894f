"""Device time a frame: the union of the trace's device intervals in the
window over the window's frames.  It shows a kernel's gain that the host
hides from frames_per_s."""


def read(ctx):
    t = ctx.trace
    if not t or t["busy_s"] <= 0 or not ctx.n_frames:
        return None
    return 1e3 * t["busy_s"] / ctx.n_frames
