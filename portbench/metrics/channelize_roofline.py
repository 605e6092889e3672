"""channelize_roofline: the least time channelize() could take on the
card (portbench.peaks.channelize_work: its bytes at HBM rate against its
float32 legs and float64 DFT product at their peaks) over channelize_ms,
in %.  Wideband configurations only."""

from portbench import peaks

UNIT = "%"


def read(ctx):
    from portbench.run import reader
    ms = reader("channelize_ms").read(ctx)
    if ms is None:
        return None
    tr = ctx.traffic
    n_in = ctx.cache["channelize_in"]
    m = (n_in - tr.k * tr.taps) // tr.k + 1
    nbytes, work = peaks.channelize_work(n_in, tr.k, m, tr.taps)
    return 100.0 * peaks.bound_s(nbytes, work) * 1e3 / ms
