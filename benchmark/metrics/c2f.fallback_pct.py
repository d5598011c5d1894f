"""The share of the window's frames whose c2f guard tripped, so that the
writer re-ran the frame at full range ("FALLBACK to full-range SGM" in the
frame's log), of the frames that ran c2f."""


def read(ctx):
    c2f = [f["fallback"] for f in ctx.frames if f.get("fallback") is not None]
    return 100.0 * sum(c2f) / len(c2f) if c2f else None
