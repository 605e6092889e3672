"""programs_per_block: the device programs the engine launched for each
resolved block (a retime, the steady or re-acquire program, a discarded
prediction and a re-hunt each count one), the mean over the window's
blocks after the traced seconds (the engine's block records:
program_counter)."""

from portbench import blocks

UNIT = "programs"


def read(ctx):
    return blocks.mean(ctx, lambda r: r["programs"])
