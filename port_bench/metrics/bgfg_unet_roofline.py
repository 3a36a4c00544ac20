"""The head's bg/fg EnhancedUNet at its least time, as a share of its device
time, in %: for each traced request, the larger of the UNet's operations on
the request's real RoIs at the card's peaks (``lib/work.py``'s int8/bf16
rule, restricted to the reference's modules under
``head/base_head/bg_vs_fg_unet/``, ``lib/unet_work.py``) and its weights
once over HBM, summed, over the device busy time of the ops launched inside
the port's ``model.head.bgfg_unet`` span in the second traced window (spans
on), which serves the same requests; nothing where the program records no
such span."""

from port_bench.lib import spec, unet_work
from port_bench.lib.peaks import bound
from port_bench.lib.spans import _command_line, served

SPAN = "model.head.bgfg_unet"


def read(ctx):
    sp = served(ctx)
    found = _command_line()
    if sp is None or not ctx.traced or found is None or sp.stage_s.get(SPAN, 0.0) <= 0:
        return None
    w = unet_work.count(spec.cell(found[0])["config"])
    least = sum(bound(w.weight_bytes, w.ops(n))["bound_s"] for _, n in ctx.traced)
    return least / sp.stage_s[SPAN] * 100.0
