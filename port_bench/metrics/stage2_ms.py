"""Device busy time a request of the work launched while the host was inside
the port's ``model.stage2`` span (RGB extractor and head), in ms, over the
second traced window (spans on)."""

from port_bench.lib.spans import served


def read(ctx):
    sp = served(ctx)
    return None if sp is None else sp.per_request_ms(sp.stage_s.get("model.stage2", 0.0))
