"""The host's enqueue cost of a frame's dispatch: the upload, the
rectification and the dense frame with all its stages, less the plane's
host read that waits on the card (loop_stats "loop.upload" +
"loop.rectify" + "dense.frame" - "plane.read", a frame, averaged over the
window's frames).  On a frame whose c2f guard tripped, the writer's
full-range re-run adds its own dense frame and plane read."""

KEYS = ("loop.upload", "loop.rectify", "dense.frame", "plane.read")


def read(ctx):
    cols = [ctx.loop_stats.get(k) or [] for k in KEYS]
    if not all(cols) or len({len(c) for c in cols}) != 1:
        return None
    upload, rectify, frame, plane_read = cols
    per_frame = [u + r + f - p for u, r, f, p in zip(upload, rectify, frame, plane_read)]
    return 1e3 * sum(per_frame) / len(per_frame)
