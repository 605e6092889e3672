"""setup_s: process start to the first timed feed(): imports, the kernels'
build (first run) or load from build/, the stream made on the card, the
receiver and its warm-up feeds (host clock)."""

UNIT = "s"


def read(ctx):
    return ctx.setup_s
