"""k3_roofline: the soft-stage kernel (symbol_soft) against its HBM bound
at the cell's window rows (portbench.peaks.symbol_soft_bytes), over its
mean time a launch in the profiler's trace, in %."""

from portbench import peaks, trace

UNIT = "%"


def read(ctx):
    if ctx.trace is None:
        return None
    got = trace.kernel_mean_s(ctx.trace, "symbol_soft")
    if got is None:
        return None
    g = ctx.geometry
    nbytes = peaks.symbol_soft_bytes(g["channels"], g["window"] // 40)
    return 100.0 * peaks.bound_s(nbytes, []) / got[0]
