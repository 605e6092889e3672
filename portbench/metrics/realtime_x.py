"""realtime_x: channel samples fed through the receiver in the window over
the channels' real-time rate (2.168 Msamples/s each) times the window's
seconds; the window runs from the first timed feed() to the return of the
final flush() and a synchronize (host clock)."""

UNIT = "x"
SAMPLE_RATE = 2_168_000.0


def read(ctx):
    w = ctx.window
    return w.channel_samples / (SAMPLE_RATE * w.seconds)
