"""engine_host_ms: the locked engine's host lifecycle ms a block (its
stats' host_ms: the resolve and the emit loop, less the wait on the
block's results), the mean over the window's blocks after the traced
seconds (timing=True, host clock)."""

UNIT = "ms"


def read(ctx):
    rows = ctx.engine.block_stats[ctx.window.traced_blocks:]
    if not rows:
        return None
    return sum(r["host_ms"] for r in rows) / len(rows)
