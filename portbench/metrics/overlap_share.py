"""overlap_share: the blocks whose program the pipelined engine launched
on its prediction, before the previous block was resolved, and used
(launch "kept"), over all blocks, in %; the window's blocks after the
traced seconds (the engine's block records: program_counter)."""

from portbench import blocks

UNIT = "%"


def read(ctx):
    v = blocks.mean(ctx, lambda r: r["launch"] == "kept")
    return None if v is None else 100.0 * v
