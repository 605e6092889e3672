"""channelize_ms: device ms of one channelize() call on the cell's own
wideband window (the filter history and one quantum of the cell's stream),
CUDA events around 10 calls in each of 5 windows after a warm-up, timed
alone once the measured window has closed; the median window.  Wideband
configurations only."""

import statistics

import torch

UNIT = "ms"
CALLS, WINDOWS = 10, 5


def read(ctx):
    if ctx.traffic.kind != "wideband":
        return None
    if "channelize_ms" in ctx.cache:
        return ctx.cache["channelize_ms"]
    from opv_tpu_torch.rx.channelizer import channelize
    tr = ctx.traffic
    hist = tr.k * tr.taps - 1
    x = tr.feeds[0]
    buf = torch.cat([torch.zeros(hist, dtype=x.dtype, device=x.device), x])
    for _ in range(3):
        channelize(buf, tr.k, tr.taps)
    torch.cuda.synchronize()
    per = []
    for _ in range(WINDOWS):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(CALLS):
            channelize(buf, tr.k, tr.taps)
        b.record()
        torch.cuda.synchronize()
        per.append(a.elapsed_time(b) / CALLS)
    ctx.cache["channelize_ms"] = statistics.median(per)
    ctx.cache["channelize_in"] = buf.shape[0]
    return ctx.cache["channelize_ms"]
