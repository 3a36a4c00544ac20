"""Each traced request's least time on the card (the larger of its useful
operations at the peaks and its images, RoIs, weights and outputs once over
HBM), summed, as a share of the device's busy time, in %."""

from port_bench.lib.peaks import bound


def read(ctx):
    if ctx.work is None or ctx.trace is None or not ctx.traced or ctx.trace.busy_s <= 0:
        return None
    least = sum(bound(ctx.work.request_bytes(b, n), ctx.work.ops(b, n))["bound_s"]
                for b, n in ctx.traced)
    return least / ctx.trace.busy_s * 100.0
