"""operands_device_ms: device ms a run of the soft stage's operands (the tone
columns, masks and phases built inside each steady program): CUDA events
around it on the engine's stream, the mean over every run completed in the
window's blocks after the traced seconds (the engine's block records:
program_span)."""

from portbench import blocks

UNIT = "ms"


def read(ctx):
    return blocks.device_ms(ctx, "operands")
