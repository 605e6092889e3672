"""device_wait_ms: the locked engine's wait on a block's results a block
(its stats' device_wait_ms: in pipelined mode what is left after the
overlap), the mean over the window's blocks after the traced seconds
(timing=True, host clock)."""

UNIT = "ms"


def read(ctx):
    rows = ctx.engine.block_stats[ctx.window.traced_blocks:]
    if not rows:
        return None
    return sum(r["device_wait_ms"] for r in rows) / len(rows)
