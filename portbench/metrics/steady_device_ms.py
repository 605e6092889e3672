"""steady_device_ms: device ms a run of the steady program (the soft stage,
frame extraction and the Viterbi decode; any device idle inside the
program counts): CUDA events around it on the engine's stream, the mean
over every run completed in the window's blocks after the traced seconds
(the engine's block records: program_span)."""

from portbench import blocks

UNIT = "ms"


def read(ctx):
    return blocks.device_ms(ctx, "steady")
