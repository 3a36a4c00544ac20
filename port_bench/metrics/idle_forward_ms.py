"""Device idle time a request whose gaps' middles fall inside the port's
``engine.forward`` span (the serving switches and the host's dispatch of
the stages), in ms, over the second traced window (spans on)."""

from port_bench.lib.spans import served


def read(ctx):
    sp = served(ctx)
    return None if sp is None else sp.per_request_ms(sp.idle_s["forward"])
