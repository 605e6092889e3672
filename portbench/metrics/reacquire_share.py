"""reacquire_share: the window's blocks that ran the re-acquire program
over all its blocks, in % (the engine's block tags, a program counter)."""

UNIT = "%"


def read(ctx):
    rows = ctx.engine.block_stats[ctx.window.blocks_at_start:]
    if not rows:
        return None
    return 100.0 * sum(r["tag"] == "reacquire" for r in rows) / len(rows)
