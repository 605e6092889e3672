"""viterbi_roofline: the Viterbi kernel (viterbi_kernel) against its bound
at the cell's frames a block, channels x block_frames
(portbench.peaks.viterbi_work: int32 issue at the card's highest SM
clock), over its mean time a launch in the profiler's trace, in %."""

from portbench import peaks, trace

UNIT = "%"


def read(ctx):
    if ctx.trace is None:
        return None
    got = trace.kernel_mean_s(ctx.trace, "viterbi_kernel")
    if got is None:
        return None
    g = ctx.geometry
    nbytes, work = peaks.viterbi_work(g["channels"] * g["block_frames"],
                                      peaks.int32_ops_per_s())
    return 100.0 * peaks.bound_s(nbytes, work) / got[0]
