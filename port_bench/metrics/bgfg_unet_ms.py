"""Device busy time a request of the work launched inside the port's
``model.head.bgfg_unet`` span (the head's bg/fg EnhancedUNet; a part of
``stage2_ms``), in ms, over the second traced window (spans on); nothing
where the program records no such span."""

from port_bench.lib.spans import served

SPAN = "model.head.bgfg_unet"


def read(ctx):
    sp = served(ctx)
    if sp is None or SPAN not in sp.stage_s:
        return None
    return sp.per_request_ms(sp.stage_s[SPAN])
