"""channelize_window_ms: device ms a run of the channelizer inside the
window, the in-window counterpart of channelize_ms: CUDA events around it
on the engine's stream, the mean over every run completed in the window's
blocks after the traced seconds (the engine's block records:
program_span)."""

from portbench import blocks

UNIT = "ms"


def read(ctx):
    return blocks.device_ms(ctx, "channelize")
