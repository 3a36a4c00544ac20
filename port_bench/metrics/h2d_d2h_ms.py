"""Device time of the host-to-device and device-to-host copies a request,
in ms, over the traced window (the engine's float32 image upload and its
mask downloads)."""


def read(ctx):
    if ctx.trace is None or not ctx.traced:
        return None
    seconds = ctx.trace.device_seconds("Memcpy HtoD") + ctx.trace.device_seconds("Memcpy DtoH")
    return seconds / len(ctx.traced) * 1e3
