"""sync_wait_ms: host ms a block spent in the engine's synchronous waits
on the whole device (a retime's estimates, an AGC update's statistics),
the mean over the window's blocks after the traced seconds (the engine's
block records: program_span)."""

from portbench import blocks

UNIT = "ms"


def read(ctx):
    return blocks.mean(ctx, lambda r: blocks.host_ms(r, "sync_wait"))
