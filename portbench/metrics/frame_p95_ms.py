"""frame_p95_ms: the 95th percentile, over every frame the window returned,
of the ms from the start of the feed() that delivered the last sample of
the frame's block to the return of the call that returned the frame (host
clock)."""

from portbench.cell import latencies_ms, quantile

UNIT = "ms"


def read(ctx):
    lat = latencies_ms(ctx.window, ctx.geometry)
    return quantile(lat, 0.95) if lat else None
