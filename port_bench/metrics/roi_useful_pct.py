"""The share of the RoIs computed that were real, 100 x sum of ``rois`` over
sum of ``rois_computed`` (the power-of-two bucket) of the port's
``engine.call`` counters, in %, over the second traced window."""

from port_bench.lib.spans import served


def read(ctx):
    sp = served(ctx)
    if sp is None or not sp.counters:
        return None
    computed = sum(c["rois_computed"] for c in sp.counters)
    return 100.0 * sum(c["rois"] for c in sp.counters) / computed if computed else None
