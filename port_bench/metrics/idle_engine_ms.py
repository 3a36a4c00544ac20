"""Device idle time a request whose gaps' middles fall while the host is
inside the port's ``engine.call`` span with no ``engine.forward`` open (pad,
upload, download), in ms, over the second traced window (spans on)."""

from port_bench.lib.spans import served


def read(ctx):
    sp = served(ctx)
    return None if sp is None else sp.per_request_ms(sp.idle_s["engine"])
