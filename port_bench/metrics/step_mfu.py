"""The least compute time of the useful work of the measured window (the
reference's conv operations for its images and real RoIs at the card's
int8 and bf16 peaks), as a share of the window's wall time, in %."""

from port_bench.lib.peaks import bound


def read(ctx):
    if ctx.work is None:
        return None
    ops = ctx.work.ops(ctx.window["images"], ctx.window["rois"])
    return bound(0.0, ops)["compute_s"] / ctx.window["seconds"] * 100.0
