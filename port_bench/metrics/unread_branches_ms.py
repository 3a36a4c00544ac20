"""Device busy time a request of the work launched inside the port's
``model.head.unread`` span (the contour and distance branches, which no
deployed output reads; a part of ``stage2_ms``), in ms, over the second
traced window (spans on)."""

from port_bench.lib.spans import served


def read(ctx):
    sp = served(ctx)
    return None if sp is None else sp.per_request_ms(sp.stage_s.get("model.head.unread", 0.0))
