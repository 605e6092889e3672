"""launch_host_ms: host ms a block spent queueing work for the device: the
engine's launch spans less the synchronous waits inside them, its append
and slide, and the wideband receiver's append, channelize and slide; the
mean over the window's blocks after the traced seconds (the engine's
block records: program_span)."""

from portbench import blocks

UNIT = "ms"
SPANS = ("append", "slide", "wideband.append", "wideband.channelize",
         "wideband.slide")


def _ms(r):
    h = r["host_ms"]
    return (h.get("launch", 0.0) - blocks.host_ms(r, "sync_wait", "launch")
            + sum(h.get(s, 0.0) for s in SPANS))


def read(ctx):
    return blocks.mean(ctx, _ms)
