"""Device busy time a request of the work launched while the host was inside
the port's ``model.stage1`` span (the UNet with its fused blocks and tail),
in ms, over the second traced window (spans on)."""

from port_bench.lib.spans import served


def read(ctx):
    sp = served(ctx)
    return None if sp is None else sp.per_request_ms(sp.stage_s.get("model.stage1", 0.0))
