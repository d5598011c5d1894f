"""The SGM stage's share of its roofline: the least time the card could
take for the SGM work the window's frames asked for, over the trace's
device time of the kernels that implement it (KERNELS, matched in the
device operation names).

The work comes from each frame's launch line: every SGM-with-WTA launch
of a c2f frame's coarse pass runs at (H/f, W/f) over the coarse range
(the full range over f, rounded up to 8) with 8 paths; further full-range
launches (a fallback's re-run, or a frame that takes no c2f) at (H, W, D);
each windowed one at (H, W, Dw).  A launch reads its uint8 cost volume
once and writes its float32 disparity once, and computes OPS_PER_PATH
integer results per cost element and path (the recurrence's minimum of
the two neighbours, + P1, the minimum with its own carry and with the P2
jump, + the cost, the running minimum for the next step, the add into
the path sum) and one per element for the winner-take-all.  The bound is
the larger of bytes over the memory rate and operations over the
operation rate of peaks.py; at these shapes operations bind.
"""

from peaks import least_seconds

KERNELS = ("sgm_path_kernel",)
OPS_PER_PATH = 7


def _launch_work(h, w, d, paths):
    n = h * w * d
    return n + 4 * h * w, (OPS_PER_PATH * paths + 1) * n


def read(ctx):
    t, peaks = ctx.trace, ctx.peaks
    if not t or not peaks:
        return None
    kernel_s = sum(s for name, s in t["by_name"].items() if any(k in name for k in KERNELS))
    if kernel_s <= 0:
        return None
    cfg = ctx.stereo
    H, W = ctx.shape
    f = cfg.c2f_factor
    coarse_d = -(-(-(-cfg.num_disp // f)) // 8) * 8
    paths = cfg.directions
    coarse_paths = paths if paths != 5 else 8
    least = 0.0
    for fr in ctx.frames:
        n = fr.get("launches", {})
        fused, windowed = n.get("sgm_wta_fused", 0), n.get("sgm_wta_fused_windowed", 0)
        coarse = 1 if (fr.get("fallback") is not None and fused) else 0
        work = [(_launch_work(H // f, W // f, coarse_d, coarse_paths), coarse),
                (_launch_work(H, W, cfg.num_disp, paths), fused - coarse),
                (_launch_work(H, W, cfg.c2f_window, paths), windowed)]
        for (nbytes, ops), count in work:
            least += count * least_seconds(nbytes, ops, peaks)[0]
    return 100.0 * least / kernel_s if least > 0 else None
